"""Device-idle ms inside a prefill forward, per forward: the time within
each "prefill.forward" host range in which no device activity ran."""
from chipbench import span_readers


def read(run):
    return span_readers.forward_idle_ms(run)
