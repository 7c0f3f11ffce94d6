"""Low-bit weight formats of the runtime What axis: packed INT4 and scaled
FP8 beside the paper's INT8 (the port's copy of `repro/quant/lowbit.py`,
under the same names).

Formats (the dict *key* is the format discriminator
`models.layers.linear` dispatches on):

  {"q":  int8 (K, N),                "scale": f32 (N,)}   INT8 (quant.int8)
  {"q4": int8 (ceil(K/2), N),        "scale": f32 (N,)}   packed INT4
  {"qf8": float8_e4m3fn (K, N),      "scale": f32 (N,)}   scaled FP8

INT4 packs two signed nibbles per int8 byte along K (even K rows in the
low nibble, odd rows in the high nibble) with a per-output-channel /7
symmetric scale; unpacking recovers the signed nibbles with arithmetic
shifts.  FP8 stores e4m3 elements with a per-output-channel scale that
maps each column's max-abs onto the e4m3 range (448).

The quantized bytes and scales are bitwise equal to the JAX package's:
the scales are `max|w| / 7 + 1e-12` and `max|w| / 448 + 1e-12` in f32,
`torch.round` rounds half to even as `jnp.round` does, the cast to
`torch.float8_e4m3fn` rounds to nearest even as XLA's does, and torch's
int8 shifts equal `jnp.left_shift` / `jnp.right_shift`.  Every function
takes stacked leading axes (..., K, N), with scales (..., N).

Both formats run the INT8 GEMM kernel when the planner gates them: INT4
unpacks its nibbles to int8 with plain torch ops first (values in
[-7, 7] are exact int8) and calls it with the /7 scale, as the reference
unpacks outside its Pallas kernel; FP8 hands the e4m3 weight to the
kernel, which decodes it in place of int8 (`kernels/int8_gemm.py`).
"""
from __future__ import annotations

import torch

from ..kernels.int8_gemm import int8_gemm
from .int8 import PROJECTION_WEIGHT_NAMES, _contract, quantize_model_params

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0          # e4m3 finite max
PRECISIONS = ("int8", "int4", "fp8")


# --- INT4: pack / unpack ----------------------------------------------------

def quantize_weight_int4(w):
    """(..., K, N) -> (packed int8 (..., ceil(K/2), N), f32 (..., N)),
    per output channel, /7 symmetric."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / 7.0 + 1e-12
    q = torch.clamp(torch.round(wf / scale[..., None, :]), -7, 7).to(
        torch.int8)
    return pack_int4(q), scale


def pack_int4(q):
    """Pack int8 values in [-8, 7] two per byte along axis -2 (K):
    (..., K, N) -> (..., ceil(K/2), N); an odd K gets a zero row."""
    if q.shape[-2] % 2:
        q = torch.cat([q, torch.zeros_like(q[..., :1, :])], dim=-2)
    lo = q[..., 0::2, :] & 0x0F
    hi = q[..., 1::2, :] << 4
    return (lo | hi).to(torch.int8)


def unpack_int4(packed, k: int):
    """Inverse of pack_int4: (..., ceil(K/2), N) int8 -> (..., K, N) int8.
    Arithmetic shifts sign-extend each nibble (int8 >> is arithmetic)."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    full = torch.stack([lo, hi], dim=-2)             # (..., Kp, 2, N)
    full = full.reshape(*packed.shape[:-2], 2 * packed.shape[-2],
                        packed.shape[-1])
    return full[..., :k, :]


def dequantize_weight_int4(packed, scale, k: int, dtype=torch.float32):
    """The canonical expression of the packed-INT4 format."""
    return unpack_int4(packed, k).to(dtype) * scale.to(dtype)[..., None, :]


# --- FP8 --------------------------------------------------------------------

def quantize_weight_fp8(w):
    """(..., K, N) -> (float8_e4m3fn (..., K, N), f32 (..., N)), per
    output channel: each column's max-abs maps onto the e4m3 range, so
    small columns keep their mantissa resolution."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2) / FP8_MAX + 1e-12
    return (wf / scale[..., None, :]).to(FP8_DTYPE), scale


def dequantize_weight_fp8(qf, scale, dtype=torch.float32):
    """The canonical expression of the FP8 format."""
    return qf.to(dtype) * scale.to(dtype)[..., None, :]


# --- epilogue-fused contractions (as quant.int8.dequant_contract) -----------

def dequant_contract_int4(x, packed, scale, spec: str | None = None):
    """x · dequant(int4) with the scale applied to the output: the nibbles
    are unpacked (a transient int8 (K, N)) and contracted in x.dtype —
    exact for int4 magnitudes in every float dtype in use.  `spec` as in
    `quant.int8.dequant_contract`."""
    q = unpack_int4(packed, x.shape[-1]).to(x.dtype)
    return _contract(x, q, scale, spec)


def dequant_contract_fp8(x, qf, scale, spec: str | None = None):
    """x · dequant(fp8) with the scale applied to the output; `spec` as in
    `quant.int8.dequant_contract`."""
    return _contract(x, qf.to(x.dtype), scale, spec)


# --- the kernel routes ------------------------------------------------------

def planned_linear_int4(x, packed, scale):
    """The gated INT4 route: unpack the nibbles to int8 on the device
    (plain torch ops) and run the INT8 GEMM kernel with the /7 scale;
    output in x.dtype."""
    lead = x.shape[:-1]
    w_q = unpack_int4(packed, x.shape[-1])
    y = int8_gemm(x.reshape(-1, x.shape[-1]), w_q, scale, out_dtype=x.dtype)
    return y.reshape(*lead, w_q.shape[1])


def planned_linear_fp8(x, qf, scale):
    """The gated FP8 route: the INT8 GEMM kernel with the e4m3 weight,
    which it decodes to bf16 (or f32) exactly; output in x.dtype."""
    lead = x.shape[:-1]
    y = int8_gemm(x.reshape(-1, x.shape[-1]), qf, scale, out_dtype=x.dtype)
    return y.reshape(*lead, qf.shape[1])


# --- format dispatch --------------------------------------------------------

def weight_format(w) -> str | None:
    """Precision token of a quantized weight sub-tree, else None."""
    if not isinstance(w, dict):
        return None
    if "q4" in w:
        return "int4"
    if "qf8" in w:
        return "fp8"
    if "q" in w:
        return "int8"
    return None


def _per_matrix(fn, w):
    """fn over each (K, N) matrix of a (..., K, N) leaf, results stacked:
    no f32 copy of a whole stacked leaf is made.  Bitwise the same as fn
    on the stacked leaf (scales are per (layer, channel) either way)."""
    if w.ndim == 2:
        return fn(w)
    parts = [_per_matrix(fn, w[i]) for i in range(w.shape[0])]
    return tuple(torch.stack([p[j] for p in parts]) for j in range(2))


def quantize_model_params_lowbit(params, precision: str = "int8"):
    """Quantize every projection weight of a parameter tree at
    `precision` ("int8", "int4" or "fp8"), walking it by name as
    `quant.int8.quantize_model_params` does.

    "int8" is `quantize_model_params`; "int4" and "fp8" give {"q4" |
    "qf8", "scale"} leaves with per-(layer, channel) scales on stacked
    leaves.  Already-quantized leaves pass through unchanged."""
    if precision == "int8":
        return quantize_model_params(params)
    if precision == "int4":
        base, key = quantize_weight_int4, "q4"
    elif precision == "fp8":
        base, key = quantize_weight_fp8, "qf8"
    else:
        raise ValueError(f"unknown precision {precision!r} "
                         "(expected int8/int4/fp8)")

    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        if (name in PROJECTION_WEIGHT_NAMES and torch.is_tensor(node)
                and node.ndim >= 2):
            qw, scale = _per_matrix(base, node)
            return {key: qw, "scale": scale}
        return node
    return walk(params)
