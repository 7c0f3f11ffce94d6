"""The JAX package's parameters as the port's torch parameters."""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, device="cuda"):
    """Nested dicts and lists of arrays (numpy, or anything `np.asarray`
    takes, such as JAX arrays) -> the same nesting of torch tensors on
    `device`.  Float leaves and quantized {"q", "scale"} leaves map leaf
    by leaf; lists of per-slot dicts stay lists.

    numpy holds JAX's bfloat16 as `ml_dtypes.bfloat16`, which torch cannot
    take; such leaves go through float32 and back to torch.bfloat16, a
    round trip that is exact."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device) for v in tree]
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":
        return torch.tensor(a.astype(np.float32), device=device).to(
            torch.bfloat16)
    return torch.tensor(a, device=device)
