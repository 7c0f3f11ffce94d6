"""Device idle share in the engine's steps: 1 minus the device-busy
union over the traced window's length."""
from chipbench import readers


def read(run):
    return readers.idle_frac(run)
