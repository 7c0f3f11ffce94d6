"""Mamba2 SSD (state-space duality) mixer in torch (the port of the JAX
package's `repro/models/mamba2.py`, under the same names;
arXiv:2405.21060).

Chunked SSD: within a chunk the recurrence is computed in its "dual"
quadratic-attention form; across chunks a loop carries the (heads,
d_state, headdim) recurrent state.  Decode is the O(1) recurrent update.

Layout conventions:
  x     : (b, l, h, p)      p = headdim
  dt, A : (b, l, h)         per-head scalar decay (A negative)
  B, C  : (b, l, g, n)      n = d_state, g = groups (broadcast over heads)

Dtypes follow the reference step by step: torch promotes bf16 with f32
to f32 as JAX does, except inside `torch.einsum`, which wants one dtype,
so `_einsum` promotes its operands first; dt goes through softplus in
f32 with JAX's formula; the depthwise conv sums its taps in the input's
dtype in the reference's order; the gated RMSNorm runs in f32.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..sharding.constraints import cumsum, einsum
from .layers import dense_init, linear


def _einsum(spec: str, *ops):
    """torch.einsum on operands promoted to one dtype (jnp.einsum's
    promotion)."""
    dt = functools.reduce(torch.promote_types, (o.dtype for o in ops))
    return einsum(spec, *(o.to(dt) for o in ops))


def _softplus(x):
    """JAX's softplus, log1p(exp(-|x|)) + max(x, 0) (torch's own returns
    x above a threshold)."""
    return torch.log1p(torch.exp(-x.abs())) + x.clamp_min(0)


def segsum(x):
    """Stable 'segment sum' producing the lower-triangular decay matrix:
    out[i, j] = sum_{k=j+1..i} x[k] for i >= j, -inf otherwise."""
    l = x.shape[-1]
    cs = cumsum(x, -1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((l, l), dtype=torch.bool, device=x.device))
    return torch.where(mask, out, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """Chunked SSD scan.  Returns (y f32, final_state f32).

    x: (b, l, h, p); dt: (b, l, h) (softplus-ed); A: (h,) negative;
    B, C: (b, l, g, n) with h % g == 0.  Raises ValueError unless
    `chunk` divides l (the reference asserts it; nothing is padded)."""
    b, l, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    nc = l // chunk
    if nc * chunk != l:
        raise ValueError(f"sequence length {l} is not a multiple of the "
                         f"SSD chunk {chunk}")
    rep = h // g

    # fold dt into x and A (discretization)
    a = A[None, None, :] * dt                     # (b, l, h)  log-decay
    xb = x * dt[..., None]                        # input scaled by dt

    def ch(t):                                    # (b, nc, cl, ...)
        return t.reshape(b, nc, chunk, *t.shape[2:])
    xc, ac, Bc, Cc = ch(xb), ch(a), ch(B), ch(C)
    Bh = torch.repeat_interleave(Bc, rep, dim=3)  # (b, nc, cl, h, n)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)

    a_cum = cumsum(ac, 2)                         # (b, nc, cl, h)
    # --- intra-chunk (dual quadratic form) ---
    L = torch.exp(segsum(ac.permute(0, 1, 3, 2)))     # (b, nc, h, cl, cl)
    scores = _einsum("bcihn,bcjhn->bchij", Ch, Bh)
    y_diag = _einsum("bchij,bcjhp->bcihp", scores * L, xc)

    # --- chunk states ---
    decay_to_end = torch.exp(a_cum[:, :, -1:, :] - a_cum)    # (b,nc,cl,h)
    states = _einsum("bcihn,bcih,bcihp->bchnp", Bh, decay_to_end, xc)

    # --- inter-chunk recurrence over nc ---
    chunk_decay = torch.exp(a_cum[:, :, -1, :])               # (b, nc, h)
    carry = (init_state.float() if init_state is not None
             else torch.zeros((b, h, n, p), dtype=torch.float32,
                              device=x.device))
    prev = []
    for c in range(nc):
        prev.append(carry)                                    # incoming
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # (b,nc,h,n,p)

    # --- contribution of the carried state to each position ---
    state_decay = torch.exp(a_cum)                            # (b,nc,cl,h)
    y_off = _einsum("bcihn,bchnp,bcih->bcihp", Ch, prev_states, state_decay)
    y = (y_diag + y_off).float().reshape(b, l, h, p)
    return y, carry


def ssd_decode_step(state, x_t, dt_t, A, B_t, C_t):
    """O(1) recurrent update for one token.

    state: (b, h, n, p); x_t: (b, h, p); dt_t: (b, h);
    B_t, C_t: (b, g, n).  Returns (y_t, new_state)."""
    h = x_t.shape[1]
    rep = h // B_t.shape[1]
    Bh = torch.repeat_interleave(B_t, rep, dim=1)     # (b, h, n)
    Ch = torch.repeat_interleave(C_t, rep, dim=1)
    decay = torch.exp(A[None, :] * dt_t)              # (b, h)
    add = _einsum("bhn,bhp->bhnp", Bh, x_t * dt_t[..., None])
    new_state = state * decay[..., None, None] + add
    y = _einsum("bhn,bhnp->bhp", Ch, new_state)
    return y, new_state


# --- full mixer (in_proj -> conv -> SSD -> gate -> out_proj) -----------------

def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype, device="cuda"):
    """One layer's mixer parameters from `gen`, with the reference's
    shapes and dtypes: separate named projections (z/x/B/C/dt), the
    depthwise conv taps, f32 A_log / dt_bias / D, the gated norm's scale
    and out_proj."""
    s = cfg.ssm
    d = cfg.d_model
    di = s.d_inner(d)
    nh = s.n_ssm_heads(d)
    gdim = s.n_groups * s.d_state

    def lin(k, n):
        return dense_init(gen, k, n, dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": lin(d, di), "w_x": lin(d, di), "w_B": lin(d, gdim),
        "w_C": lin(d, gdim), "w_dt": lin(d, nh),
        "conv_x": (torch.randn((s.d_conv, di), generator=gen, **f32)
                   * 0.02).to(dtype),
        "conv_B": torch.full((s.d_conv, gdim), 0.02, dtype=dtype,
                             device=device),
        "conv_C": torch.full((s.d_conv, gdim), 0.02, dtype=dtype,
                             device=device),
        "A_log": torch.zeros((nh,), **f32),    # A = -exp(A_log) in [-1, 0)
        "dt_bias": torch.zeros((nh,), **f32),
        "D": torch.ones((nh,), **f32),
        "norm_scale": torch.ones((di,), dtype=dtype, device=device),
        "out_proj": lin(di, d),
    }


def _causal_conv(xBC, w, carry=None):
    """Depthwise causal conv over (b, l, c) with kernel (k, c).

    carry: (b, k-1, c) previous context (decode) or None (zero pad).
    Returns (silu(y), new_carry).  The taps are summed in xBC's dtype in
    the reference's order, starting from Python's 0."""
    k = w.shape[0]
    b, l, c = xBC.shape
    pad = (carry if carry is not None
           else torch.zeros((b, k - 1, c), dtype=xBC.dtype,
                            device=xBC.device))
    dt = torch.promote_types(pad.dtype, xBC.dtype)
    xp = torch.cat([pad.to(dt), xBC.to(dt)], dim=1)
    # sum_k w[k] * x[t - (K-1) + k]
    y = sum(xp[:, i:i + l, :] * w[i] for i in range(k))
    new_carry = xp[:, -(k - 1):, :] if k > 1 else None
    return F.silu(y), new_carry


def mamba_apply(params, x, cfg: ModelConfig, state=None, conv_carry=None,
                decode: bool = False, plan=None):
    """x: (b, l, d).  Prefill when decode=False (l = seq; the SSD chunk is
    min(cfg.ssm.chunk, l), which must divide l); decode=True expects
    l == 1 and a (state, conv_carry) cache.
    Returns (y, (new_state, new_conv_carry))."""
    s = cfg.ssm
    b, l, d = x.shape
    di = s.d_inner(d)
    gdim = s.n_groups * s.d_state
    nh = s.n_ssm_heads(d)
    z = linear(params["w_z"], x, "ssm-z", plan)
    xs = linear(params["w_x"], x, "ssm-x", plan)
    # B/C/dt are one fused GEMM in the planner's taxonomy ("ssm-BCdt"):
    # three weights, one verdict
    B, C, dt = (linear(params[w], x, "ssm-BCdt", plan)
                for w in ("w_B", "w_C", "w_dt"))
    dt = _softplus(dt.float() + params["dt_bias"])         # (b, l, nh)
    A = -torch.exp(params["A_log"])                        # (nh,)

    # depthwise causal conv on x / B / C separately (carry is concat)
    if conv_carry is not None:
        cx, cB, cC = (conv_carry[..., :di], conv_carry[..., di:di + gdim],
                      conv_carry[..., di + gdim:])
    else:
        cx = cB = cC = None
    xs, nx = _causal_conv(xs, params["conv_x"], cx)
    B, nB = _causal_conv(B, params["conv_B"], cB)
    C, nC = _causal_conv(C, params["conv_C"], cC)
    new_conv = torch.cat([nx, nB, nC], dim=-1) if nx is not None else None
    p = s.headdim
    xh = xs.reshape(b, l, nh, p)
    Bh = B.reshape(b, l, s.n_groups, s.d_state)
    Ch = C.reshape(b, l, s.n_groups, s.d_state)

    if decode:
        y_t, new_state = ssd_decode_step(
            state, xh[:, 0], dt[:, 0], A, Bh[:, 0], Ch[:, 0])
        y = y_t[:, None]                                   # (b, 1, nh, p)
    else:
        y, new_state = ssd_chunked(xh, dt, A, Bh, Ch,
                                   chunk=min(s.chunk, l), init_state=state)
    y = y + xh * params["D"][None, None, :, None]
    y = y.reshape(b, l, di)
    # gated RMSNorm (mamba2 norm-before-gate), in f32
    yf = y.float()
    yf = yf * torch.rsqrt(yf.square().mean(-1, keepdim=True)
                          + cfg.rmsnorm_eps)
    y = (yf * params["norm_scale"].float()).to(x.dtype)
    y = y * F.silu(z)
    return linear(params["out_proj"], y, "ssm-out", plan), \
        (new_state, new_conv)


def mamba_cache_shapes(cfg: ModelConfig, batch: int):
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_ssm_heads(cfg.d_model)
    gdim = s.n_groups * s.d_state
    return ((batch, nh, s.d_state, s.headdim),            # ssm state
            (batch, s.d_conv - 1, di + 2 * gdim))          # conv carry
