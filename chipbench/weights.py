"""Random weights from the seed, made by the benchmark and handed to both
sides: the program quantizes them itself, the reference works its own
INT8 weights out from them.

Each stacked leaf is drawn whole, in the dtype the program takes it
(bf16; the MoE router f32), by one `torch.randn` on the device from a
generator of its own, seeded from the run's seed and the leaf's path, and
scaled in place: a leaf can be drawn again alone, and the same seed gives
the same weights.  The tree has the program's layout (`repro_torch.models
.init`: one entry per slot of the period, each leaf stacked over the
layers) and the program's scales (projections 1 / sqrt(fan-in), embedding
and head 0.02); norm scales are 1 + 0.1 N(0, 1) and the attention biases
0.1 N(0, 1), so that neither is an identity.
"""
from __future__ import annotations

import zlib

import torch

BF16 = torch.bfloat16


def leaf_seed(seed: int, path: str) -> int:
    return (seed * 1_000_003 + zlib.crc32(path.encode())) % 2 ** 63


def draw(seed: int, path: str, shape, device, dtype=BF16, scale=1.0,
         shift=0.0):
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path))
    t = torch.randn(tuple(shape), generator=gen, device=device, dtype=dtype)
    if scale != 1.0:
        t.mul_(scale)
    if shift:
        t.add_(shift)
    return t


def leaf_specs(m: dict) -> list[tuple[str, tuple, torch.dtype, float, float]]:
    """(path, shape, dtype, scale, shift) of every leaf, paths written as
    the keys from the root joined by "/" (slot 0 of the period: "slots/0")."""
    d, V, L = m["d_model"], m["vocab"], m["n_layers"]
    H, KV = m["n_heads"], m["n_kv_heads"]
    dh = m.get("d_head") or d // H
    specs = [("embed", (V, d), BF16, 0.02, 0.0),
             ("lm_head", (d, V), BF16, 0.02, 0.0),
             ("final_norm/scale", (d,), BF16, 0.1, 1.0)]
    s = "slots/0/"
    specs += [(s + "norm1/scale", (L, d), BF16, 0.1, 1.0),
              (s + "attn/wq", (L, d, H * dh), BF16, d ** -0.5, 0.0),
              (s + "attn/wk", (L, d, KV * dh), BF16, d ** -0.5, 0.0),
              (s + "attn/wv", (L, d, KV * dh), BF16, d ** -0.5, 0.0),
              (s + "attn/wo", (L, H * dh, d), BF16, (H * dh) ** -0.5, 0.0)]
    if m.get("qkv_bias"):
        specs += [(s + "attn/bq", (L, H * dh), BF16, 0.1, 0.0),
                  (s + "attn/bk", (L, KV * dh), BF16, 0.1, 0.0),
                  (s + "attn/bv", (L, KV * dh), BF16, 0.1, 0.0)]
    specs.append((s + "norm2/scale", (L, d), BF16, 0.1, 1.0))
    moe = m.get("moe")
    if moe:
        E, f = moe["n_experts"], moe["expert_d_ff"]
        specs += [(s + "moe/router", (L, d, E), torch.float32, d ** -0.5, 0.0),
                  (s + "moe/w_gate", (L, E, d, f), BF16, d ** -0.5, 0.0),
                  (s + "moe/w_up", (L, E, d, f), BF16, d ** -0.5, 0.0),
                  (s + "moe/w_down", (L, E, f, d), BF16, f ** -0.5, 0.0)]
        if moe["n_shared_experts"]:
            sf = moe["shared_d_ff"]
            specs += [(s + "moe/shared/w_gate", (L, d, sf), BF16, d ** -0.5,
                       0.0),
                      (s + "moe/shared/w_up", (L, d, sf), BF16, d ** -0.5,
                       0.0),
                      (s + "moe/shared/w_down", (L, sf, d), BF16,
                       sf ** -0.5, 0.0)]
    else:
        f = m["d_ff"]
        specs += [(s + "mlp/w_gate", (L, d, f), BF16, d ** -0.5, 0.0),
                  (s + "mlp/w_up", (L, d, f), BF16, d ** -0.5, 0.0),
                  (s + "mlp/w_down", (L, f, d), BF16, f ** -0.5, 0.0)]
    return specs


def make(m: dict, seed: int, device) -> dict:
    """The whole tree, in the program's layout."""
    if m["family"] not in ("dense", "moe"):
        raise ValueError(f"weights for family {m['family']!r} are not "
                         "written yet")
    tree: dict = {"slots": [{}]}
    for path, shape, dtype, scale, shift in leaf_specs(m):
        keys = path.split("/")
        node = tree
        if keys[0] == "slots":
            node, keys = tree["slots"][int(keys[1])], keys[2:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = draw(seed, path, shape, device, dtype, scale, shift)
    return tree
