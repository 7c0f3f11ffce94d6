"""Random weights from the seed, made by the benchmark and handed to both
sides: the program quantizes them itself, the reference works its own
INT8 weights out from them.

Each stacked leaf is drawn whole, in the dtype the program takes it, by
one `torch.randn` on the device from a generator of its own, seeded from
the run's seed and the leaf's path, and scaled and shifted in place: a
leaf can be drawn again alone, and the same seed gives the same weights.
The architecture's module (`chipbench/archs/<arch>.py: leaf_specs`)
lists the leaves, their shapes, dtypes and scales; the tree has the
program's layout (`repro_torch.models.init`: one entry per slot of the
period under "slots", each leaf stacked over the layers).
"""
from __future__ import annotations

import zlib

import torch

from . import spec

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


def make(arch: str, m: dict, seed: int, device) -> dict:
    """The whole tree of the architecture `arch`'s leaves (its
    `leaf_specs`), in the program's layout."""
    tree: dict = {"slots": [{}]}
    for path, shape, dtype, scale, shift in spec.arch(arch).leaf_specs(m):
        keys = path.split("/")
        node = tree
        if keys[0] == "slots":
            node, keys = tree["slots"][int(keys[1])], keys[2:]
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = draw(seed, path, shape, device, dtype, scale, shift)
    return tree
