"""The projections' device ms per engine step: the span "proj" of the
captured step (every `linear` but the expert contractions, the LM head
and the shared expert included)."""
from chipbench import span_readers


def read(run):
    return span_readers.section_ms(run, ("proj",))
