"""Multi-objective Pareto reduction for design-space campaigns.

The campaign layer (core/campaign.py) scores 100k+-point design grids and
keeps the non-dominated frontier over (energy, latency, area proxy).
The reduction comes in three layers, held to each other and to the JAX
package's by tests/test_torch_campaign.py:

  * `dominates(a, b)` / `pareto_mask_ref(points)` — the scalar O(n²)
    reference: `a` dominates `b` iff a <= b on every objective and a < b
    on at least one (all minimized).  Exact ties dominate in neither
    direction, so duplicates stay on the front together.
  * `pareto_mask(points)` — the same predicate as torch ops over an
    (n, d) tensor, all pairs compared by broadcast, on the tensor's
    device.  `pareto_mask_np` is the host entry point (numpy in and
    out, CPU tensors in between): it pads to a power of two with +inf
    rows as the reference does, which can never dominate a row with a
    finite objective.
  * `ParetoAccumulator` — cross-chunk front merging through
    pareto(A ∪ B) == pareto(pareto(A) ∪ pareto(B)); `front()` emits rows
    sorted by their caller-assigned index, so the output does not depend
    on how the stream was cut.

All comparisons are in float32, the dtype the sweep backends emit.  Rows
with non-finite objectives are filtered out before reduction.
"""
from __future__ import annotations

import numpy as np
import torch


def dominates(a, b) -> bool:
    """Scalar reference: does point `a` dominate point `b`?"""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return bool(np.all(a <= b) and np.any(a < b))


def pareto_mask_ref(points) -> np.ndarray:
    """O(n²) reference front mask: keep[j] iff no row dominates row j."""
    pts = np.asarray(points, np.float32)
    n = pts.shape[0]
    keep = np.ones(n, bool)
    for j in range(n):
        for i in range(n):
            if i != j and dominates(pts[i], pts[j]):
                keep[j] = False
                break
    return keep


def pareto_mask(points):
    """Front mask of an (n, d) tensor (all objectives minimized): an (n,)
    bool tensor on the same device, True for non-dominated rows.

    le[i, j] is "i <= j on every objective", lt[i, j] "i < j on at least
    one"; row j is dominated iff some i has both.  O(n²d) work and O(n²)
    memory: large streams go through `ParetoAccumulator`."""
    pts = torch.as_tensor(points).to(torch.float32)
    le = torch.all(pts[:, None, :] <= pts[None, :, :], dim=-1)
    lt = torch.any(pts[:, None, :] < pts[None, :, :], dim=-1)
    return ~torch.any(le & lt, dim=0)


def _pad_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def pareto_mask_np(points) -> np.ndarray:
    """Host entry point: pad the (n, d) matrix to the next power of two
    with +inf rows, run `pareto_mask` on the CPU, return the real rows'
    mask as a numpy bool array."""
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2:
        raise ValueError(f"points must be (n, d), got shape {pts.shape}")
    n = pts.shape[0]
    if n == 0:
        return np.zeros(0, bool)
    m = _pad_pow2(n)
    if m != n:
        pts = np.concatenate(
            [pts, np.full((m - n, pts.shape[1]), np.inf, np.float32)])
    return pareto_mask(torch.from_numpy(pts)).numpy()[:n]


class ParetoAccumulator:
    """Streaming front reduction with cross-chunk merging.

    Feed chunks of (points, indices) in any order and any cut; only the
    running non-dominated set is kept (O(front + chunk) rows).  `indices`
    are caller-assigned global identifiers; `front()` emits the
    surviving rows sorted by index."""

    def __init__(self, n_objectives: int):
        if n_objectives < 1:
            raise ValueError(
                f"n_objectives must be >= 1, got {n_objectives}")
        self.n_objectives = n_objectives
        self._points = np.zeros((0, n_objectives), np.float32)
        self._indices = np.zeros(0, np.int64)
        self.rows_seen = 0
        self.chunks_merged = 0

    def update(self, points, indices) -> None:
        """Fold one chunk of candidate rows into the running front."""
        pts = np.asarray(points, np.float32)
        idx = np.asarray(indices, np.int64)
        if pts.ndim != 2 or pts.shape[1] != self.n_objectives:
            raise ValueError(
                f"expected (n, {self.n_objectives}) points, "
                f"got shape {pts.shape}")
        if idx.shape != (pts.shape[0],):
            raise ValueError(
                f"indices shape {idx.shape} does not match "
                f"{pts.shape[0]} points")
        if not np.isfinite(pts).all():
            raise ValueError(
                "non-finite objectives reached the front reduction — "
                "filter invalid rows before accumulating")
        self.rows_seen += pts.shape[0]
        self.chunks_merged += 1
        if pts.shape[0] == 0:
            return
        keep = pareto_mask_np(pts)               # reduce the chunk first
        cat = np.concatenate([self._points, pts[keep]])
        cat_idx = np.concatenate([self._indices, idx[keep]])
        keep = pareto_mask_np(cat)               # then the union
        self._points = cat[keep]
        self._indices = cat_idx[keep]

    def __len__(self) -> int:
        return int(self._points.shape[0])

    def front(self) -> tuple[np.ndarray, np.ndarray]:
        """(points, indices) of the current front, sorted by index."""
        order = np.argsort(self._indices, kind="stable")
        return self._points[order], self._indices[order]
