"""INT8 GEMM roofline share (%) in the engine's steps: the summed
bounds of the traced window's kernel calls over their device time."""
from chipbench import readers


def read(run):
    return readers.gemm_roofline(run)
