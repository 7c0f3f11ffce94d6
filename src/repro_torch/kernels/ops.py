"""Public wrappers around the attention and INT8 kernels, with the JAX
package's layouts (`repro/kernels/ops.py`).

The JAX wrappers repeat the kv heads (GQA) and fold heads into the batch
before calling their Pallas kernels.  Here the heads are folded without
the repeat: query head h of batch b becomes row b*H + h and kv head g row
b*KV + g, and the kernels read kv row (b*H + h) // (H // KV) — the same
function on fewer bytes.  Each wrapper takes its kernel's plain version
only for CPU tensors (see the kernel modules).  `paged_decode_attention`
(the engine's decode attention over a block pool, which the JAX package
leaves to XLA) already takes the (b, 1, H, d) layout and is re-exported
as it is, as is `paged_mla_decode` (the latent attention step, which the
JAX package does not have).
"""
from __future__ import annotations

from .decode_attention import decode_attention as _decode_attention
from .decode_attention import paged_decode_attention  # noqa: F401
from .flash_attention import flash_attention as _flash_attention
from .int8_gemm import int8_gemm
from .mla_decode import paged_mla_decode  # noqa: F401


def fold(t):
    """(b, s, heads, d) -> (b * heads, s, d), contiguous: the kernels'
    folded layout."""
    b, s, n, d = t.shape
    return t.transpose(1, 2).reshape(b * n, s, d).contiguous()


def unfold(t, b: int):
    """(b * heads, s, d) -> (b, s, heads, d)."""
    bn, s, d = t.shape
    return t.reshape(b, bn // b, s, d).transpose(1, 2)


def _check_heads(q, k) -> None:
    if q.ndim != 4 or k.ndim != 4 or q.shape[0] != k.shape[0] or (
            q.shape[2] % k.shape[2]):
        raise ValueError(f"want q (b, s, H, d) and k/v (b, s, KV, d) with H "
                         f"a multiple of KV; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")


def int8_matmul(x, w_q, w_scale, dataflow: str = "os", block_m: int = 0,
                block_n: int = 0, block_k: int = 0):
    """y = x @ dequant(w_q) in f32 (the INT8 GEMM kernels; w_q int8 or
    float8 e4m3, as the JAX wrapper takes either).  The block
    arguments are kept only for parity with the JAX wrapper's signature and
    are unused: the Hopper kernels choose their own tiles and mask ragged
    tails.  dataflow="os" is the output-stationary kernel the model runs
    (design A or B by shape), "ws" the weight-stationary split-K kernel
    (design B at every M); f32 x takes the FMA kernel on either
    (`int8_gemm.plan_gemm`)."""
    return int8_gemm(x, w_q, w_scale, dataflow=dataflow)


def flash_attention(q, k, v, causal: bool = True, window: int = 0,
                    block_q: int = 128, block_kv: int = 128):
    """q: (b, sq, H, d); k/v: (b, sk, KV, d) GQA.  Returns (b, sq, H, d)."""
    _check_heads(q, k)
    o = _flash_attention(fold(q), fold(k), fold(v), causal=causal,
                         window=window, block_q=block_q, block_kv=block_kv)
    return unfold(o, q.shape[0])


def decode_attention(q, k_cache, v_cache, length, block_kv: int = 512):
    """q: (b, 1, H, d); caches: (b, S, KV, d); length: () valid prefix.
    Returns (b, 1, H, d)."""
    _check_heads(q, k_cache)
    o = _decode_attention(fold(q), fold(k_cache), fold(v_cache), length,
                          block_kv=block_kv)
    return unfold(o, q.shape[0])
