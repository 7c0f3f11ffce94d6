"""The INT8 GEMM's block report (the port of the JAX package's
`kernels/autotune.py`, without a second chooser).

The JAX package's Pallas kernel takes its blocks as arguments, chosen by
a pinned table of shape classes with `core.tpu_adapter.choose_blocks`
(the WWW priorities against a VMEM budget) as the fallback, and every
block must divide its dim.  The port's CUDA kernels fix their tiles at
compile time and mask their tails, so no divisibility contract applies
and nothing here chooses: `kernels.int8_gemm.plan_gemm` is the one place
that decides a call's kernel and geometry, and this module reports what
that plan runs, from the constants of `csrc/int8_gemm.cu`:

* design "A" — output tiles of `A_BM` x `A_BN` (128 x 64), K streamed
  in `A_BK` (64)-row stages through a `A_STAGES` (4)-deep TMA ring
  (`ga::BM`, `ga::BN`, `ga::BK`, `ga::STAGES`);
* design "B" — one block holds all of M (in chunks of at most 64 rows),
  `B_BN` (128) columns and one K slice of `plan.kslice` rows
  (`gb::BN`; the kslice is `plan_gemm`'s), `plan.splits` slices;
* "fma" — blocks of `F_BM` x `F_BN` (8 x 128) outputs, x staged `F_BK`
  (32) K rows at a time (`F_BM`, `F_BN`, `F_BK`).

`int8_gemm_smem_bytes` is a design's shared memory per block from the
same constants; it stays within the 227 KiB a Hopper block may opt into.
`sweep_block_rows` has no counterpart: the sweep kernel runs one thread
per row in 256-thread blocks (`csrc/sweep_eval.cu`) and has nothing to
choose.
"""
from __future__ import annotations

import math

from .int8_gemm import A_COLS, A_ROWS, B_COLS, GemmPlan, plan_gemm

SMEM_LIMIT = 227 * 1024      # opt-in shared memory per block, sm_90

# design A (`ga::` in csrc/int8_gemm.cu)
A_BM, A_BN = A_ROWS, A_COLS  # 128 x 64 output tile
A_BK = 64                    # K rows per TMA stage
A_STAGES = 4                 # TMA ring depth
A_BSTAGES = 3                # converted bf16 weight tiles
# design B (`gb::`)
B_BN = B_COLS                # 128 columns per block
B_KP = 64                    # K rows per weight piece
B_STAGES = 5                 # pieces in flight
B_XROW = B_KP + 8            # bf16 per staged x row
# f32 x ("fma")
F_BM, F_BN, F_BK = 8, 128, 32


def int8_gemm_blocks(M: int, N: int, K: int, *,
                     x_bf16: bool = True) -> tuple[int, int, int]:
    """(block_m, block_n, block_k) of the kernel `plan_gemm` runs for an
    output-stationary (M, K) x (K, N) call with contiguous, 16-byte
    aligned operands."""
    plan = plan_gemm(M, N, K, x_bf16=x_bf16)
    if plan.design == "A":
        return A_BM, A_BN, A_BK
    if plan.design == "B":
        return M, B_BN, plan.kslice
    return F_BM, F_BN, F_BK


def _b_row_tiles(M: int) -> int:
    """Design B's 16-row tiles per chunk of x (the launcher's MT)."""
    rows = min(M, 64)
    return 1 if rows <= 16 else 2 if rows <= 32 else 4


def int8_gemm_smem_bytes(design: str, M: int = 1) -> int:
    """Shared memory per block of `design` (design B's depends on M)."""
    if design == "A":
        return (A_STAGES * A_BM * A_BK * 2 + A_BSTAGES * A_BK * A_BN * 2
                + A_STAGES * A_BK * A_BN + 2 * A_STAGES * 8 + 1024)
    if design == "B":
        return (B_STAGES * B_KP * B_BN
                + B_STAGES * 16 * _b_row_tiles(M) * B_XROW * 2)
    if design == "fma":
        return F_BM * F_BK * 4
    raise ValueError(f"unknown design {design!r}")


def grid_blocks(M: int, N: int, plan: GemmPlan) -> int:
    """Blocks of the GEMM kernel's launch (design B's reduce pass, a
    second launch when plan.splits > 1, not counted)."""
    if plan.design == "A":
        return math.ceil(M / A_BM) * math.ceil(N / A_BN)
    if plan.design == "B":
        return math.ceil(N / B_BN) * plan.splits
    return math.ceil(N / F_BN) * math.ceil(M / F_BM)


def autotune_report(shapes=((8, 512, 256), (8, 256, 2048),
                            (1024, 1024, 1024), (4096, 128, 512))
                    ) -> list[dict]:
    """What the GEMM runs for a bf16 x at each (M, N, K) shape (the JAX
    package's exemplar shapes by default): the design (in place of the
    table entry), its blocks, design B's K splits, shared memory per
    block in KiB and the launch's blocks."""
    rows = []
    for M, N, K in shapes:
        plan = plan_gemm(M, N, K)
        rows.append({"shape": (M, N, K), "design": plan.design,
                     "blocks": int8_gemm_blocks(M, N, K),
                     "splits": plan.splits,
                     "smem_kib": int8_gemm_smem_bytes(plan.design, M)
                     / 1024,
                     "grid_blocks": grid_blocks(M, N, plan)})
    return rows
