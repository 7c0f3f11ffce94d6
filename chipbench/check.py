"""What decides `correct`: the widest gap (or a cell's stated quantile of
the gaps) by which a token the program put first lies below the
reference's best logit at that position.

For a served request the tokens are the ones it served: the reference
runs once over its prompt and served tokens, and at the position that
produced served token j (prompt_len - 1 + j) reads max(logits) minus the
logit of that token.  For a prefill forward the tokens are the program's
argmax at every position of the prompt.  A sound program only loses a
near-tie there; a program that computes in a lower precision, skips work
or alters a token puts tokens first that the reference ranks lower.

The control reads the same gap for the token the reference computed
with INT4 weights (the precision below the configuration's INT8) puts
first, at the same positions.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference, spec


def top_gaps(arch: str, m: dict, params: dict, seqs: list, reads: list,
             chosen: list, control_bits: int | None = None):
    """Per sequence, the gap of each read position (float32 numpy) of the
    tokens `chosen[i]` put first at reads[i], by the reference of the
    architecture `arch`; with `control_bits` also the gaps of the tokens
    the reference at that precision puts first (else None)."""
    ref = spec.arch(arch)
    h8 = ref.final_hidden(m, params, seqs, reads, 8)
    w8 = ref.head(params, 8)
    if control_bits:
        h_c = ref.final_hidden(m, params, seqs, reads, control_bits)
        w_c = ref.head(params, control_bits)
    out, ctl = [], []
    for i, h in enumerate(h8):
        parts, cparts = [], []
        for a, lg in reference.logits(h, w8):
            best = lg.max(-1).values
            c = chosen[i][a:a + lg.shape[0]].to(lg.device).long()
            parts.append((best - lg.gather(1, c[:, None])[:, 0]).cpu().numpy())
            if control_bits:
                with reference.no_tf32(), torch.inference_mode():
                    cc = (h_c[i][a:a + lg.shape[0]] @ w_c).argmax(-1)
                cparts.append((best - lg.gather(1, cc[:, None])[:, 0])
                              .cpu().numpy())
        out.append(np.concatenate(parts) if parts else np.zeros(0))
        ctl.append(np.concatenate(cparts) if cparts else np.zeros(0))
    return out, (ctl if control_bits else None)


def served(samples: list, device):
    """(seqs, reads, chosen) of served requests: samples are (prompt,
    served tokens) pairs."""
    seqs, reads, chosen = [], [], []
    for prompt, toks in samples:
        toks = np.asarray(toks, np.int64)
        seq = np.concatenate([np.asarray(prompt, np.int64), toks[:-1]])
        p = len(prompt)
        seqs.append(torch.from_numpy(seq).to(device))
        reads.append(torch.arange(p - 1, p - 1 + len(toks), device=device))
        chosen.append(torch.from_numpy(toks).to(device))
    return seqs, reads, chosen


def scored(samples: list, device):
    """(seqs, reads, chosen) of prefill forwards: samples are (prompt,
    the program's argmax at every position) pairs."""
    seqs, reads, chosen = [], [], []
    for prompt, top in samples:
        seqs.append(torch.from_numpy(np.asarray(prompt, np.int64)).to(device))
        reads.append(torch.arange(len(prompt), device=device))
        chosen.append(torch.as_tensor(top, device=device))
    return seqs, reads, chosen


def verdict(gaps: list, check: dict) -> dict:
    """The numbers compared, each with its limit, and whether all hold:
    the gaps' `quantile` (percent, numpy's linear interpolation; 100, the
    default, is the widest gap) over every compared position, and how
    many positions were compared."""
    q = check.get("quantile", 100)
    name = "top_token_gap" if q == 100 else f"top_token_gap_p{q}"
    flat = np.concatenate(gaps) if gaps else np.zeros(0)
    value = float(np.percentile(flat, q)) if flat.size else float("inf")
    checks = {name: {"value": value, "limit": check["limit"]},
              "tokens_compared": {"value": int(flat.size),
                                  "limit": check["min_tokens"]}}
    ok = flat.size >= check["min_tokens"] and value <= check["limit"]
    return {"correct": bool(ok), "checks": checks}
