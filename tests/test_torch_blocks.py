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
  default engine.
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
