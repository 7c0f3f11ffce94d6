"""The routed experts' device ms per engine step: the spans "moe.router"
and "moe.experts" of the captured step."""
from chipbench import span_readers


def read(run):
    return span_readers.section_ms(run, ("moe.router", "moe.experts"))
