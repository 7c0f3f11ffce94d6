"""Grouped INT8 experts -- the hand-written Hopper kernels of the MoE
decode step's routed experts, beside their plain torch version.

They replace no TPU kernel: the JAX package leaves the experts to XLA,
whose T <= C path (`models/moe.py:moe_apply`) runs every expert over every
token with three dequant einsums.  Here each routed expert's int8 weights
are read once per layer and run only over the tokens routed to it.

Contract: x (T, d) activations; expert_ids (T, k) integer expert ids,
each token's k distinct experts in selection order; w_gate, w_up INT8
leaves {"q": (E, d, f) int8, "scale": (E, f) f32}, w_down {"q": (E, f,
d), "scale": (E, d)} -> (T, k, d) in x's dtype: out[t, j] is expert e =
ids[t, j] applied to x[t],

    h        = silu(x[t] . dequant(Wg[e])) * (x[t] . dequant(Wu[e]))
    out[t, j] = h . dequant(Wd[e])

with the contractions summed in f32 over x and the exact int8 weights,
each per-channel scale and the SiLU in f32, and h and the output each
rounded once to x's dtype.  The caller weights out[t, j] by the router
and sums over j.

The CUDA source is `csrc/moe_experts.cu` (its header gives the bound and
the design: two kernels, gate / up and down); `kernels/build.py` compiles
it with nvcc for sm_90a at first use and loads it with ctypes.
`moe_experts` takes the launch path of `kernels/launch.py`; its plain
version, `moe_experts_ref`, is a loop over the experts with their rows
found on the host.  Nothing is read on the host and nothing synced, so a
CUDA graph can capture the call.  A call counts two launches, one per
kernel ("gate_up", "down").  The kernels' names hold no "int8_gemm", and
their launches go to no other wrapper's counter.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import launch
from .build import KernelBuild, build_library

K_STEP = 64                      # csrc/moe_experts.cu: KS (rows a stage)
PASS_ROWS = 32                   # csrc/moe_experts.cu: NTOK (rows a pass)
DESIGNS = ("gate_up", "down")
# the plain version's tolerance, which the card tests and chip_smoke.py
# state with every comparison
# the whole tensor's bound: rms(got - ref) / rms(ref).  The per-element
# bound is loose where P is many times |ref|, so a twice-rounded result
# passes it; the RMS does not.  At d 2048, f 1408 on the CPU a sum in
# another f32 order rounded once reads 6e-5 to 1.4e-4, the twice-rounded
# dequant einsums (bf16 product, then the scale) 6.3e-3.
MOE_RMS_TOL = 2.0 ** -10
MOE_TOL_DOC = ("against moe_experts_ref: per element 1.02 * 2^-7 * (|ref| "
               "+ P), P = (|h| @ |q_down|) * scale_down from the plain "
               "version's h: one bf16 ulp of the output and one of each h "
               "element, which may round the other way after f32 sums in "
               "another order; and over the whole tensor rms(got - ref) <= "
               "2^-10 rms(ref), which a result rounded twice exceeds")


@functools.lru_cache(maxsize=None)
def build() -> KernelBuild:
    """Compile (once per source hash) and load the kernel library."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    return build_library("moe_experts", moe_experts_launch=(
        [vp, vp, i32, i32] + [vp] * 8 + [i32] * 4 + [vp]))


def _routed(expert_ids, n_experts: int):
    """Per expert, its assignment indices a = t * k + j in ascending order
    (a host read: the plain version only)."""
    flat = expert_ids.reshape(-1)
    return [(e, (flat == e).nonzero()[:, 0]) for e in range(n_experts)]


def _hidden(x, rows, k: int, e: int, w_gate, w_up):
    """Expert e's h over assignment rows `rows` (tokens rows // k): f32
    contractions and scales, SiLU in f32, rounded once to x's dtype."""
    xe = x[rows // k].float()
    g = (xe @ w_gate["q"][e].float()) * w_gate["scale"][e].float()
    u = (xe @ w_up["q"][e].float()) * w_up["scale"][e].float()
    return (F.silu(g) * u).to(x.dtype)


def moe_experts_ref(x, expert_ids, w_gate, w_up, w_down):
    """The plain version: each expert's routed rows gathered, contracted in
    f32 against its int8 weights, scaled per channel, h and the output
    rounded once to x's dtype (the kernels' function; see the module
    docstring)."""
    T, k = expert_ids.shape
    out = x.new_empty((T * k, x.shape[1]))
    for e, rows in _routed(expert_ids, w_gate["q"].shape[0]):
        if rows.numel():
            h = _hidden(x, rows, k, e, w_gate, w_up)
            out[rows] = ((h.float() @ w_down["q"][e].float())
                         * w_down["scale"][e].float()).to(x.dtype)
    return out.view(T, k, -1)


def moe_experts_check(got, x, expert_ids, w_gate, w_up, w_down) -> dict:
    """Hold a moe_experts result `got` (T, k, d) against `moe_experts_ref`
    within MOE_TOL_DOC's bounds, element by element and over the whole
    tensor.  Returns {"ok", "max_abs_err", "worst" (the largest |d| /
    bound), "rel_err" (max|d| / max|ref|), "rms_rel" (rms(d) /
    rms(ref))}."""
    T, k = expert_ids.shape
    ref = moe_experts_ref(x, expert_ids, w_gate, w_up, w_down).float()
    # P: each output's sum of |h| |w| s terms, from the plain version's h
    mag = torch.zeros_like(ref).view(T * k, -1)
    for e, rows in _routed(expert_ids, w_gate["q"].shape[0]):
        if rows.numel():
            h = _hidden(x, rows, k, e, w_gate, w_up).float()
            mag[rows] = (h.abs() @ w_down["q"][e].float().abs()) * (
                w_down["scale"][e].float())
    diff = (got.float() - ref).abs()
    bound = 1.02 * 2.0 ** -7 * (ref.abs() + mag.view_as(ref)) + 1e-30
    rms_rel = float(diff.pow(2).mean().sqrt()
                    / ref.pow(2).mean().sqrt().clamp_min(1e-30))
    return {"ok": bool((diff <= bound).all()) and rms_rel <= MOE_RMS_TOL,
            "max_abs_err": float(diff.max()),
            "worst": float((diff / bound).max()),
            "rel_err": float(diff.max() / ref.abs().max().clamp_min(1e-30)),
            "rms_rel": rms_rel}


def _leaves(w_gate, w_up, w_down):
    return (("w_gate", w_gate), ("w_up", w_up), ("w_down", w_down))


def check_experts(x, expert_ids, w_gate, w_up, w_down) -> None:
    """Validate the shapes and dtypes every device takes."""
    if x.ndim != 2 or expert_ids.ndim != 2 or (
            expert_ids.shape[0] != x.shape[0]):
        raise ValueError(f"moe_experts wants x (T, d) and expert_ids (T, k); "
                         f"got {tuple(x.shape)}, {tuple(expert_ids.shape)}")
    if expert_ids.is_floating_point() or expert_ids.dtype == torch.bool:
        raise TypeError(f"expert_ids must be integers, got "
                        f"{expert_ids.dtype}")
    for name, w in _leaves(w_gate, w_up, w_down):
        if not (isinstance(w, dict) and "q" in w and "scale" in w) or (
                w["q"].dtype != torch.int8):
            raise TypeError(f"moe_experts takes INT8 leaves {{'q', 'scale'}}; "
                            f"{name} is not one")
    d = x.shape[1]
    E, _, f = w_gate["q"].shape
    want = {"w_gate": (E, d, f), "w_up": (E, d, f), "w_down": (E, f, d)}
    for name, w in _leaves(w_gate, w_up, w_down):
        if tuple(w["q"].shape) != want[name] or (
                tuple(w["scale"].shape) != (E, want[name][2])):
            raise ValueError(f"{name}: want q {want[name]} and scale "
                             f"{(E, want[name][2])} for x of width {d}; got "
                             f"{tuple(w['q'].shape)}, "
                             f"{tuple(w['scale'].shape)}")


def check_experts_card(x, expert_ids, w_gate, w_up, w_down) -> None:
    """The CUDA kernels' contract beyond `check_experts`: bf16 x, f32
    scales, d and f multiples of K_STEP (each is one kernel's contracted
    width and the other's output width), every tensor contiguous.  Raises TypeError
    / ValueError."""
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernels take bfloat16 x, got {x.dtype}")
    d, f = x.shape[1], w_gate["q"].shape[2]
    if d % K_STEP or f % K_STEP:
        raise ValueError(f"the CUDA kernels want d and f multiples of "
                         f"{K_STEP}; got d {d}, f {f}")
    for name, w in _leaves(w_gate, w_up, w_down):
        if w["scale"].dtype != torch.float32:
            raise TypeError(f"{name}'s scale must be float32, got "
                            f"{w['scale'].dtype}")
        if not (w["q"].is_contiguous() and w["scale"].is_contiguous()):
            raise ValueError(f"{name}'s q and scale must be contiguous")
    if x.shape[0] * expert_ids.shape[1] >= 2 ** 31:
        raise ValueError("T * k exceeds the kernels' int32 indices")


def row_chunks(T: int, k: int, E: int) -> int:
    """Blocks that share one (expert, column tile), each taking every
    chunks-th pass of PASS_ROWS rows: enough that an expert with 4x the
    mean rows (T k / E) is done in one round, at most ceil(T / PASS_ROWS)
    (an expert has at most T rows)."""
    return max(1, min(-(-T // PASS_ROWS), -(-4 * T * k // (E * PASS_ROWS))))


@launch.counted(*DESIGNS)
def moe_experts(x, expert_ids, w_gate, w_up, w_down):
    """x (T, d), expert_ids (T, k), the three INT8 expert leaves -> (T, k,
    d) in x's dtype (see the module docstring).

    On the card: bf16 x, d and f multiples of 64; expert_ids are read as
    int64 (others are converted, one copy), x made contiguous; two
    launches, gate / up into a (T k, f) bf16 scratch and down.  Forward
    only: raises a RuntimeError while autograd records and x requires
    grad."""
    launch.refuse_autograd("moe_experts", x)
    check_experts(x, expert_ids, w_gate, w_up, w_down)
    dev = launch.device("moe_experts", "x, expert_ids and the expert weights",
                        x, expert_ids, w_gate["q"], w_up["q"], w_down["q"])
    if dev.type == "cpu":
        return moe_experts_ref(x, expert_ids, w_gate, w_up, w_down)
    T, k = expert_ids.shape
    d = x.shape[1]
    if dev.type == "meta":
        return x.new_empty((T, k, d))
    check_experts_card(x, expert_ids, w_gate, w_up, w_down)
    E, _, f = w_gate["q"].shape
    if E > 65535:
        raise ValueError(f"{E} experts exceed the kernels' grid")
    x = x.contiguous()
    ids = expert_ids.to(torch.int64).contiguous()
    h = torch.empty((T * k, f), dtype=x.dtype, device=dev)
    out = torch.empty((T, k, d), dtype=x.dtype, device=dev)
    launch.run(moe_experts, dev, build().lib.moe_experts_launch,
               x.data_ptr(), ids.data_ptr(), T, k, w_gate["q"].data_ptr(),
               w_gate["scale"].data_ptr(), w_up["q"].data_ptr(),
               w_up["scale"].data_ptr(), w_down["q"].data_ptr(),
               w_down["scale"].data_ptr(), h.data_ptr(), out.data_ptr(), E,
               d, f, row_chunks(T, k, E), designs=DESIGNS)
    return out
