"""Decode attention's device ms per engine step: the spans
"attn.kv_write", "attn.gather" and "attn.core" of the captured step."""
from chipbench import span_readers


def read(run):
    return span_readers.section_ms(
        run, ("attn.kv_write", "attn.gather", "attn.core"))
