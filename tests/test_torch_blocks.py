"""The INT8 GEMM's block report and the last public names of the port,
on the CPU.

* `kernels.autotune`: at the JAX package's block-test shapes
  (tests/test_decode_hotpath.py:305-308) the blocks `int8_gemm_blocks`
  reports are legal for the CUDA kernel `plan_gemm` picks: they cover M,
  N and K, design B's K slice is a multiple of 16 and its slices cover
  K, and shared memory stays within the 227 KiB a Hopper block may take;
  decode M takes design B, prefill M design A with 128-row tiles; the
  report covers the JAX package's four exemplar shapes; the module's
  constants are those of `csrc/int8_gemm.cu`.
* `quant.quantize_tree` bit for bit against the JAX package's on
  tests/test_substrate.py's inputs, and `quantization_error` to 1e-6
  relative (its codes and scales are bit for bit; the two f32 norms sum
  in another order);
* `models.layers.count_params` / `param_bytes` equal to the JAX
  package's on every reduced arch;
* module-level `core.sweep.cache_info` / `cache_clear` act on the
  default engine;
* the kernels' one launch path (`kernels/launch.py`): the registry holds
  the six wrappers a replayed CUDA graph credits, with their counters;
  `snapshot` / `since` / `credit` round-trip a fake capture's counts as
  `StepGraph` uses them; a launch's return code is checked before any
  count moves; every wrapper refuses mixed devices and a device it does
  not run on.
"""
import math
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import reduced as jreduced
from repro.models import init as jinit
from repro.models.layers import count_params as jcount_params
from repro.models.layers import param_bytes as jparam_bytes
from repro.quant.int8 import quantization_error as jquantization_error
from repro.quant.int8 import quantize_tree as jquantize_tree

from repro_torch.configs import ARCHS
from repro_torch.configs.base import reduced
from repro_torch.core import GEMM, plan_workload
from repro_torch.core import sweep
from repro_torch.kernels import autotune
from repro_torch.kernels.int8_gemm import A_MIN_ROWS, plan_gemm
from repro_torch.models import init
from repro_torch.models.layers import count_params, param_bytes
from repro_torch.quant import quantization_error, quantize_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK_SHAPES = [(1, 512, 256), (8, 512, 256), (8, 256, 2048),
                (64, 1024, 1024), (256, 128, 512), (1024, 1024, 1024),
                (4096, 96, 768), (7, 130, 96)]


@pytest.mark.parametrize("M,N,K", BLOCK_SHAPES)
@pytest.mark.parametrize("x_bf16", [True, False])
def test_int8_gemm_blocks_legal(M, N, K, x_bf16):
    plan = plan_gemm(M, N, K, x_bf16=x_bf16)
    bm, bn, bk = autotune.int8_gemm_blocks(M, N, K, x_bf16=x_bf16)
    grid = autotune.grid_blocks(M, N, plan)
    if plan.design == "B":
        assert bm == M and bn == autotune.B_BN
        assert bk == plan.kslice and bk % 16 == 0
        assert plan.splits * bk >= K > (plan.splits - 1) * bk
        assert grid == math.ceil(N / bn) * plan.splits
    else:
        assert math.ceil(M / bm) * math.ceil(N / bn) == grid
        assert bk >= 1 and K >= 1             # K streamed in bk-row steps
    assert grid * bm * bn >= M * N            # the blocks cover the output
    assert autotune.int8_gemm_smem_bytes(plan.design, M) \
        <= autotune.SMEM_LIMIT


def test_int8_gemm_shape_classes():
    for M in (1, 8, A_MIN_ROWS):
        assert plan_gemm(M, 3584, 3584).design == "B"
        assert autotune.int8_gemm_blocks(M, 3584, 3584)[0] == M
    assert plan_gemm(4096, 4096, 4096).design == "A"
    assert autotune.int8_gemm_blocks(4096, 4096, 4096) == (128, 64, 64)
    assert autotune.int8_gemm_blocks(8, 512, 256, x_bf16=False) == \
        (8, 128, 32)


def test_autotune_report_covers_exemplars():
    rows = autotune.autotune_report()
    assert [r["shape"] for r in rows] == [(8, 512, 256), (8, 256, 2048),
                                          (1024, 1024, 1024),
                                          (4096, 128, 512)]
    assert [r["design"] for r in rows] == ["B", "B", "A", "A"]
    for r in rows:
        M, N, K = r["shape"]
        assert r["blocks"] == autotune.int8_gemm_blocks(M, N, K)
        assert 0 < r["smem_kib"] <= autotune.SMEM_LIMIT / 1024
        assert r["grid_blocks"] >= 1


def test_autotune_constants_match_the_cuda_source():
    src = open(os.path.join(REPO, "src", "repro_torch", "kernels", "csrc",
                            "int8_gemm.cu")).read()

    def const(ns, name):
        body = src[src.index(f"namespace {ns} {{"):] if ns else src
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             body).group(1))
    assert (autotune.A_BM, autotune.A_BN, autotune.A_BK, autotune.A_STAGES,
            autotune.A_BSTAGES) == tuple(const("ga", n) for n in (
                "BM", "BN", "BK", "STAGES", "BSTAGES"))
    assert (autotune.B_BN, autotune.B_KP, autotune.B_STAGES) == tuple(
        const("gb", n) for n in ("BN", "KP", "STAGES"))
    assert (autotune.F_BM, autotune.F_BN, autotune.F_BK) == tuple(
        const(None, n) for n in ("F_BM", "F_BN", "F_BK"))


def test_quantize_tree_matches_reference():
    tree = {"big": np.ones((512, 512), np.float32),
            "vec": np.ones((512,), np.float32),
            "rand": np.random.default_rng(3).standard_normal(
                (256, 64)).astype(np.float32)}
    want = jquantize_tree({k: jax.numpy.asarray(v) for k, v in tree.items()},
                          min_size=1024)
    got = quantize_tree({k: torch.from_numpy(v) for k, v in tree.items()},
                        min_size=1024)
    for k in ("big", "rand"):
        assert isinstance(got[k], dict) and got[k]["q"].dtype == torch.int8
        np.testing.assert_array_equal(got[k]["q"].numpy(),
                                      np.asarray(want[k]["q"]))
        np.testing.assert_array_equal(got[k]["scale"].numpy(),
                                      np.asarray(want[k]["scale"]))
    assert got["vec"].dtype == torch.float32 and torch.is_tensor(got["vec"])


@pytest.mark.parametrize("seed", [1, 2, 3, 4, 5])
def test_quantization_error_matches_reference(seed):
    w = np.array(jax.random.normal(jax.random.PRNGKey(seed), (64, 32)))
    want = jquantization_error(jax.numpy.asarray(w))
    got = quantization_error(torch.from_numpy(w))
    assert got < 0.01
    assert got == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_params_and_bytes_match_reference(arch):
    jp = jinit(jax.random.PRNGKey(0), jreduced(JARCHS[arch]))
    tp = init(torch.Generator().manual_seed(0), reduced(ARCHS[arch]),
              device="meta")
    assert count_params(tp) == jcount_params(jp)
    assert param_bytes(tp) == jparam_bytes(jp)


def test_module_level_cache_calls_act_on_default_engine():
    eng = sweep.default_engine("cpu")
    sweep.cache_clear("cpu")
    assert sweep.cache_info("cpu")["size"] == 0
    plan_workload([GEMM(8, 256, 256)], device="cpu")
    info = sweep.cache_info("cpu")
    assert info == eng.cache_info() and info["size"] > 0
    assert info["misses"] > 0
    sweep.cache_clear("cpu")
    assert eng.cache_info()["size"] == 0 and eng.cache_info()["misses"] == 0


# --- the kernels' one launch path ------------------------------------------

COUNTED = {"int8_gemm": ("A", "B", "fma"), "flash_attention": ("wgmma", "fma"),
           "decode_attention": ("mma", "fma"),
           "paged_decode_attention": ("paged",), "paged_mla_decode": ("mla",),
           "moe_experts": ("gate_up", "down")}


def test_launch_registry_holds_the_counted_wrappers():
    """The registry is the six wrappers whose counts a replay credits, each
    the package's attribute with its counters per design (and the GEMM's
    per weight format); the sweep kernel counts but is not in it."""
    from repro_torch import kernels
    from repro_torch.kernels import launch
    assert sorted(w.__name__ for w in launch.REGISTRY) == sorted(COUNTED)
    for w in launch.REGISTRY:
        assert w is getattr(kernels, w.__name__)
        assert isinstance(w.launches, int)
        assert tuple(w.launches_by_design) == COUNTED[w.__name__]
        assert hasattr(w, "launches_by_format") == (w is kernels.int8_gemm)
    assert tuple(kernels.int8_gemm.launches_by_format) == ("int8", "fp8")
    assert kernels.sweep_eval not in launch.REGISTRY
    assert isinstance(kernels.sweep_eval.launches, int)


def _fake_card(monkeypatch):
    """Let `launch.run` reach a launcher on a CPU-only torch: device 0 is
    current and its stream's handle is 0."""
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda i: 0,
                        raising=False)
    return torch.device("cuda", 0)


def test_snapshot_credit_round_trip_a_capture(monkeypatch):
    """A step's launches counted during a fake capture are taken back out
    (a capture launches nothing) and credited on each replay, as
    `StepGraph` does: two replays count what two eager steps count."""
    from repro_torch.kernels import (int8_gemm, launch, moe_experts,
                                     paged_mla_decode)
    card = _fake_card(monkeypatch)

    def step():
        for _ in range(3):
            launch.run(int8_gemm, card, lambda *a: 0, designs=("B",),
                       formats=("fp8",))
        launch.run(moe_experts, card, lambda *a: 0, designs=("gate_up",
                                                               "down"))
        launch.run(paged_mla_decode, card, lambda *a: 0, designs=("mla",))
    start = launch.snapshot()
    fp8, moe = int8_gemm.launches_by_format["fp8"], moe_experts.launches
    try:
        step()
        step()
        eager = launch.snapshot()
        assert int8_gemm.launches_by_format["fp8"] == fp8 + 6
        assert moe_experts.launches == moe + 4
        launch.credit(launch.since(start), sign=-1)
        assert launch.snapshot() == start
        before = launch.snapshot()
        step()                                   # the capture
        credit = launch.since(before)
        # int8_gemm: 3 launches, 3 on B, 3 fp8; moe: 2, one a design; mla 2
        assert sum(credit) == 9 + 4 + 2 and min(credit) == 0
        launch.credit(credit, sign=-1)
        assert launch.snapshot() == before
        launch.credit(credit)                    # two replays
        launch.credit(credit)
        assert launch.snapshot() == eager
    finally:
        launch.credit(launch.since(start), sign=-1)


@pytest.mark.parametrize("rc,note", [(700, False), (10001, True)])
def test_launch_return_code_raises_before_counting(monkeypatch, rc, note):
    from repro_torch.kernels import flash_attention, launch
    card = _fake_card(monkeypatch)
    before = launch.snapshot()
    with pytest.raises(RuntimeError, match=f"CUDA error {rc}") as err:
        launch.run(flash_attention, card, lambda *a: rc, 1, 2,
                   designs=("wgmma",))
    assert ("CUresult" in str(err.value)) == note
    assert launch.snapshot() == before


class _Elsewhere(torch.Tensor):
    """A tensor's metadata on a device no wrapper runs on."""

    @staticmethod
    def __new__(cls, t):
        return torch.Tensor._make_wrapper_subclass(
            cls, t.shape, dtype=t.dtype, strides=t.stride(), device="xla")

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise NotImplementedError(f"{func} on a device of metadata only")


def _wrapper_call(name):
    """(wrapper, arguments) of a valid call on small CPU tensors."""
    from repro_torch import kernels
    gen = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=gen)

    def q8(*shape):
        return torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)
    tables = torch.arange(6, dtype=torch.int32).view(2, 3)
    lengths = torch.tensor([5, 17])
    args = {
        "int8_gemm": (r(4, 8), q8(8, 16), r(16)),
        "flash_attention": (r(2, 16, 16), r(2, 16, 16), r(2, 16, 16)),
        "decode_attention": (r(2, 1, 16), r(2, 32, 16), r(2, 32, 16), 5),
        "paged_decode_attention": (r(2, 1, 4, 16), r(6, 8, 2, 16),
                                   r(6, 8, 2, 16), tables, lengths),
        "paged_mla_decode": (r(2, 4, 16), r(6, 8, 16), tables, lengths, 0.25,
                             8),
        "moe_experts": (r(3, 16), torch.tensor([[0, 1], [2, 3], [1, 2]]),
                        {"q": q8(4, 16, 8), "scale": r(4, 8)},
                        {"q": q8(4, 16, 8), "scale": r(4, 8)},
                        {"q": q8(4, 8, 16), "scale": r(4, 16)}),
        "sweep_eval": (r(24, 5),),
    }[name]
    return getattr(kernels, name), args


def _moved(args, to, which=None):
    """`args` with tensor number `which` (every one if None, dict leaves
    included, in order) passed through `to`."""
    seen = [-1]

    def one(t):
        if not torch.is_tensor(t):
            return t
        seen[0] += 1
        return to(t) if which in (None, seen[0]) else t
    return tuple({k: one(v) for k, v in a.items()} if isinstance(a, dict)
                 else one(a) for a in args)


@pytest.mark.parametrize("name", sorted(COUNTED) + ["sweep_eval"])
def test_every_wrapper_refuses_devices_it_does_not_run_on(name):
    """Each of the seven wrappers goes through `launch.device`: tensors
    split over two devices raise "share a device" (the sweep kernel takes
    one tensor), and a device other than cuda, cpu and meta raises."""
    wrapper, args = _wrapper_call(name)
    with torch.no_grad():
        wrapper(*args)                            # the call is valid
        if name != "sweep_eval":
            with pytest.raises(ValueError, match="share a device"):
                wrapper(*_moved(args, lambda t: t.to("meta"), which=1))
        with pytest.raises(ValueError,
                           match=rf"{name} runs on cuda \(or cpu/meta\)"):
            wrapper(*_moved(args, _Elsewhere))
