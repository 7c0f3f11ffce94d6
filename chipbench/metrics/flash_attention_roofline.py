"""Flash-attention roofline share (%): the summed bounds of the traced
window's calls (causal operations at each prompt's length) over the
kernel's device time."""
from chipbench import readers


def read(run):
    return readers.flash_roofline(run)
