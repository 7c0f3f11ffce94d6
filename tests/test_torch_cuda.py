"""The hand-written Hopper INT8 GEMM kernel against its plain version, on
the card.  These tests carry the `cuda` marker and skip where torch has no
CUDA device; on a machine with an H100 run them with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: the kernel and the plain version sum the same f32 products
(bf16 x times an int8 weight is exact in f32) in different orders, so
max|Δ| ≤ 1e-4 · max|ref|.
"""
import pytest
import torch

from repro_torch.kernels import int8_gemm, int8_gemm_ref

pytestmark = pytest.mark.cuda

TOL = 1e-4
# qwen2-7b projections (K, N): Wq/Wo, Wk/Wv, mlp-gate/up, mlp-down, lm_head
FULL_WIDTH = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
              (3584, 152064)]
RAGGED = [(5, 300, 1000), (1, 17, 33), (17, 129, 65), (130, 1000, 37),
          (200, 333, 77), (8, 18944, 3584)]


@pytest.fixture
def cuda():
    """The card, decided when the test runs (never at import time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: "
                    "python -m pytest -m cuda tests/test_torch_cuda.py)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(m, k, n, dtype, device, seed=0):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((m, k), generator=gen).to(dtype)
    q = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    s = torch.rand(n, generator=gen) * 0.02 + 1e-3
    return x.to(device), q.to(device), s.to(device)


def _check(x, q, s):
    got = int8_gemm(x, q, s)
    want = int8_gemm_ref(x, q, s)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= TOL * want.abs().max().item(), err


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("mkn", RAGGED, ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_ragged(cuda, mkn, dtype):
    _check(*_inputs(*mkn, dtype, cuda))


@pytest.mark.parametrize("m", [8, 128])
@pytest.mark.parametrize("kn", FULL_WIDTH, ids=lambda t: "x".join(map(str, t)))
def test_kernel_matches_plain_full_width(cuda, kn, m):
    _check(*_inputs(m, *kn, torch.bfloat16, cuda, seed=m))


def test_kernel_strided_x(cuda):
    """x may be a row-strided view (unit column stride)."""
    x, q, s = _inputs(8, 512, 256, torch.bfloat16, cuda)
    wide = torch.zeros((8, 520), dtype=torch.bfloat16, device=cuda)
    wide[:, 3:515] = x
    _check(wide[:, 3:515], q, s)


def test_launch_counter(cuda):
    x, q, s = _inputs(8, 256, 128, torch.bfloat16, cuda)
    before = int8_gemm.launches
    int8_gemm(x, q, s)
    int8_gemm(x, q, s)
    assert int8_gemm.launches == before + 2
    int8_gemm(x.cpu(), q.cpu(), s.cpu())          # plain version: no launch
    int8_gemm_ref(x, q, s)
    assert int8_gemm.launches == before + 2


def test_wrapper_rejects_bad_inputs(cuda):
    x, q, s = _inputs(8, 256, 128, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        int8_gemm(x, q.cpu(), s)
    with pytest.raises(TypeError):
        int8_gemm(x.half(), q, s)
    with pytest.raises(ValueError, match="unit column stride"):
        int8_gemm(x, q.t().contiguous().t(), s)
