"""Named sharding rules: parameter/optimizer/batch/cache PartitionSpecs,
and their DTensor placements (the port of the JAX package's
`sharding/rules.py`).

Scheme (single pod (data, model); multi-pod adds a leading "pod" axis that
joins the data-parallel group):
  * TP over "model": attention heads / FFN hidden / experts / vocab.
  * FSDP over "data" (optional, rc.fsdp): the non-TP dim of every large
    weight is sharded over the data axis.
  * Batch over ("pod","data"); decode KV caches shard sequence over
    "model" (flash-decoding style) and batch over "data".

Rules match on (leaf name, ndim) — stacked layer params carry a leading
period dimension that is never sharded.  They walk a port tree (dicts and
lists of tensors, meta or real) and work on a `DeviceMesh` or an
`launch.mesh.abstract_mesh`.

A PartitionSpec names mesh axes for each tensor dim; DTensor placements
name a tensor dim for each mesh dim.  `to_placements` converts one into
the other: P(("pod", "data"), None) on the mesh (pod, data, model) is
[Shard(0), Shard(0), Replicate()].  DTensor splits a dim over its mesh
dims in mesh order, which is JAX's major-to-minor order only when the
tuple lists them in mesh order, so a tuple in any other order raises.
`legalize` keeps the JAX package's rule of dropping an axis that does
not divide the dim (DTensor could shard unevenly), so the spec trees
stay the JAX package's.

The dry run (`launch/dryrun.py`) places a model's parameters, optimizer
state, batch and cache by these rules as DTensors; the JAX package's
sharding constraints inside the model (q/k/v under rc.shard_attn /
shard_heads, the residual under sp_residual) are the redistribution
points of `sharding.constraints`.
"""
from __future__ import annotations

import dataclasses

from ..configs.base import ModelConfig, RunConfig
from ..tree import map_with_path


def _canonical(entry):
    """A spec entry as JAX canonicalizes it: an empty tuple is None, a
    one-axis tuple is the axis name."""
    if isinstance(entry, (tuple, list)):
        if not entry:
            return None
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: None (replicated), an axis name, or a
    tuple of axis names (the dim split over several mesh axes, major to
    minor).  A tuple, so len(spec), spec[:-1] and spec[-1:] read as in
    the JAX package."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_canonical(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh, with its DTensor placements (one per mesh
    dim)."""
    mesh: object
    spec: PartitionSpec
    placements: tuple


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "axis_names", None)
    return tuple(names if names is not None else mesh.mesh_dim_names)


def _axis_sizes(mesh) -> dict:
    if hasattr(mesh, "axis_names"):             # launch.mesh.AbstractMesh
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def batch_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def _param_rule(name: str, ndim: int, cfg: ModelConfig, rc: RunConfig,
                parent: str) -> P:
    fsdp = "data" if rc.fsdp else None
    tp = "model"
    ep_ok = cfg.moe and cfg.moe.n_experts % 16 == 0

    # --- embeddings / heads ---
    if name == "embed":
        return P(None, tp, fsdp) if ndim == 3 else P(tp, fsdp)
    if name == "lm_head":
        return P(None, fsdp, tp) if ndim == 3 else P(fsdp, tp)

    # --- MoE expert banks: 4D (period, E, in, out) ---
    if ndim == 4 and name in ("w_gate", "w_up", "w_down"):
        if ep_ok:
            return P(None, tp, fsdp, None)          # expert parallel
        if name == "w_down":
            return P(None, None, tp, fsdp)          # TP inside expert
        return P(None, None, fsdp, tp)
    if name == "router":
        return P(None, None, None)

    # --- column-parallel (d -> hidden) ---
    if name in ("wq", "wk", "wv", "w_gate", "w_up", "w_z", "w_x", "w_dt"):
        return P(None, fsdp, tp)
    # --- row-parallel (hidden -> d) ---
    if name in ("wo", "w_down", "out_proj"):
        return P(None, tp, fsdp)
    # --- small replicated projections ---
    if name in ("w_B", "w_C"):
        return P(None, fsdp, None)
    if name in ("conv_x",):
        return P(None, None, tp)
    if name in ("conv_B", "conv_C"):
        return P(None, None, None)
    # --- vectors ---
    if name in ("bq", "bk", "bv", "norm_scale"):
        return P(None, tp)
    if name in ("A_log", "dt_bias", "D"):
        return P(None, tp)
    return P(*([None] * ndim))


def param_specs(tree_shapes, cfg: ModelConfig, rc: RunConfig):
    """PartitionSpec tree for a params (or optimizer-state) shape tree.

    Optimizer moments nest the param path (m/..., v/.../vr): the rule key
    is the innermost *weight* name on the path; adafactor's factored vr/vc
    drop the corresponding trailing dims of the parent spec.
    """
    def spec_for(names, leaf):
        name = names[-1]
        factored = None
        if name in ("vr", "vc") and len(names) >= 2:
            factored, name = name, names[-2]
        ndim = leaf.ndim + (1 if factored else 0)
        spec = _param_rule(name, ndim, cfg, rc,
                           names[-2] if len(names) >= 2 else "")
        if factored == "vr":      # parent spec minus last dim
            spec = P(*spec[:-1])
        elif factored == "vc":    # parent spec minus second-to-last dim
            spec = P(*(spec[:-2] + spec[-1:]))
        if len(spec) != leaf.ndim:
            # scalars (step) and anything unmatched: replicate
            spec = P(*([None] * leaf.ndim))
        return spec

    return map_with_path(spec_for, tree_shapes)


def batch_specs(tree_shapes, mesh):
    """Shard every batch leaf's leading dim over (pod, data)."""
    ba = batch_axes(mesh)

    def spec_for(names, leaf):
        if leaf.ndim == 0:
            return P()
        if leaf.shape[0] == 1:      # un-shardable singleton batch
            return P(*([None] * leaf.ndim))
        return P(ba, *([None] * (leaf.ndim - 1)))
    return map_with_path(spec_for, tree_shapes)


def cache_specs(tree_shapes, mesh, cfg: ModelConfig,
                seq_shard: bool = True):
    """KV/state cache specs: (period, batch, S, kv, dh) — batch over
    "data", sequence over "model" (flash-decoding SP) when batch alone
    cannot saturate the mesh; mamba states shard heads over "model"."""
    ba_all = batch_axes(mesh)        # ("pod","data") on the multi-pod mesh
    sizes = _axis_sizes(mesh)

    def _baxis(b: int):
        """Largest batch-axis tuple that divides the cache batch."""
        axes = list(ba_all)
        while axes:
            total = 1
            for a in axes:
                total *= sizes[a]
            if b % total == 0:
                return tuple(axes) if len(axes) > 1 else axes[0]
            axes.pop(0)              # drop "pod" first
        return None

    def spec_for(names, leaf):
        name = names[-1]
        if name in ("k", "v", "k_scale", "v_scale"):
            baxis = _baxis(leaf.shape[1])
            saxis = "model" if seq_shard else None
            rest = [None] * (leaf.ndim - 3)
            return P(None, baxis, saxis, *rest)
        if name == "state":         # (period, b, nh, n, p)
            return P(None, _baxis(leaf.shape[1]), "model", None, None)
        if name == "conv":          # (period, b, k-1, channels)
            return P(None, _baxis(leaf.shape[1]), None, None)
        return P(*([None] * leaf.ndim))
    return map_with_path(spec_for, tree_shapes)


def _map_specs(fn, specs, *others):
    """fn(spec, *nodes of `others` at its place) over a spec tree, whose
    leaves are PartitionSpecs (tuples, so they end the walk)."""
    if isinstance(specs, PartitionSpec):
        return fn(specs, *others)
    if isinstance(specs, dict):
        return {k: _map_specs(fn, v, *(o[k] for o in others))
                for k, v in specs.items()}
    return type(specs)(_map_specs(fn, v, *(o[i] for o in others))
                       for i, v in enumerate(specs))


def legalize(spec_tree, shape_tree, mesh):
    """Drop mesh axes from any spec dim that does not divide the global
    dim size (e.g. mamba2's vocab 50280 cannot shard 16-way and falls
    back to replicated-on-that-dim)."""
    sizes = _axis_sizes(mesh)

    def fix(spec, leaf):
        dims = list(spec) + [None] * (leaf.ndim - len(spec))
        out = []
        for size, ax in zip(leaf.shape, dims):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            total = 1
            for a in axes:
                total *= sizes[a]
            out.append(ax if size % total == 0 else None)
        return P(*out)
    return _map_specs(fix, spec_tree, shape_tree)


def to_placements(spec, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: for each mesh dim,
    Shard(d) where tensor dim d names that axis, else Replicate().
    Raises on an unknown axis, an axis named by two dims, and a tuple
    whose axes are not in mesh order (DTensor would split them in another
    order than JAX's major to minor)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    owner: dict = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {spec} names axis {a!r}, not in "
                                 f"mesh axes {names}")
            if a in owner:
                raise ValueError(f"spec {spec} shards over axis {a!r} "
                                 f"twice")
            owner[a] = dim
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec {spec}: dim {dim} lists axes {axes} "
                             f"out of mesh order {names}; DTensor splits "
                             f"a dim over its mesh dims in mesh order")
    return tuple(Shard(owner[n]) if n in owner else Replicate()
                 for n in names)


def to_named(mesh, spec_tree, shape_tree=None):
    """A tree of NamedSharding(mesh, spec, placements), legalized against
    `shape_tree` first when it is given."""
    if shape_tree is not None:
        spec_tree = legalize(spec_tree, shape_tree, mesh)
    return _map_specs(lambda s: NamedSharding(mesh, s,
                                              to_placements(s, mesh)),
                      spec_tree)
