"""The model's redistribution points: where a step whose tensors are
DTensors (the dry run's, `launch/dryrun.py`) changes a placement.

GSPMD, which partitions the JAX package's step, all-gathers FSDP-sharded
weights where they are used, pads uneven head counts, and reads the
model's `with_sharding_constraint` calls (q/k/v under rc.shard_attn /
rc.shard_heads, the residual under rc.sp_residual).  DTensor does none of
these by itself: it propagates placements op by op and refuses a view it
cannot propagate.  So the port's model calls these functions at the same
points:

* `gather_fsdp` — a layer's weights, replicated over the data-parallel
  mesh axes ("pod", "data") where they are used (the FSDP all-gather;
  under autograd its backward reduce-scatters the gradient);
* `split_heads` — (b, s, n·d) -> (b, s, n, d): heads over "model" where
  n divides the mesh axes that shard the flat dim, else the projection
  replicated over them first (the smallest redistribution that lets the
  view propagate);
* `constrain_qkv` / `constrain_residual` — the JAX package's constraints,
  driven by the same RunConfig fields and `rc.batch_axes`; without
  rc.sp_residual the residual stream is made whole over "model"
  (`replicate_over_model`), where GSPMD's propagation puts it and
  DTensor's op-by-op choice does not;
* `reduce_partial` — the rows an embedding looked up in a vocab-sharded
  table (a partial sum over "model"), all-reduced where they are made
  (DTensor cannot reduce-scatter that partial later);
* `einsum` — torch.einsum, but an einsum over DTensors whose shards all
  lie on letters of the output (no contracted letter sharded: b, h)
  runs on the local shards, each operand sliced to the output's shards.
  torch.einsum flattens the batch letters into one bmm dim, and DTensor
  (in torch 2.11) cannot flatten two sharded dims (batch over "data"
  and heads over "model").  Where two operands shard different letters
  over one mesh axis, the smaller is replicated there (decode's query
  against a cache sharded along its sequence);
* `on_local_shards` — a function independent per batch row and head
  (causal self-attention) run on each rank's shards of those dims, its
  inputs placed as the query is;
* `merge_heads` — (b, s, n, d) -> (b, s, n·d) before the row-parallel
  output projection, sliced over "model" as that projection reads it;
* `pick_last` — each row's element at an index (the loss's gold logit):
  DTensor cannot gather along a sharded vocab dim, so over DTensors it is
  the JAX package's masked sum on each rank's shard (the same number),
  then all-reduced;
* `logsumexp` — along the last dim: over a DTensor, the max, the sum of
  exponentials and the log as separate reductions, each of which DTensor
  runs on the local shards of a sharded vocab with a small all-reduce
  (its logsumexp gathers the whole vocab on every rank);
* `put_rows` — zeros with rows put at index tensors (the MoE dispatch's
  scatter into its expert buffer): DTensor in torch 2.11 has no
  strategy for index_put_, so over DTensors the put runs on every
  rank's replica of the (small) tokens and indices;
* `grad_placed` — the loss's per-token terms, whose gradient is put back
  on their own placements before it spreads: the mean's backward hands
  on a replicated gradient, its expansion over the vocab is a view, and
  DTensor splits that view one mesh axis at a time, copying each step
  (on the 2x16x16 mesh, half the global batch's logits per rank);
* `cumsum` — along an unsharded dim, on the local shards;
* `batch_rows` — a microbatch: over a DTensor sharded along its batch,
  each rank takes that part of its own shard (data parallelism per
  microbatch; slicing the global batch would gather it);
* `index_copy_` — a cache write at a position: on a cache sharded along
  the written dim (the decode KV cache, sequence over "model"), each rank
  writes the rows that fall in its shard, as XLA partitions a
  dynamic_update_slice (DTensor has no strategy for it).

On plain tensors (every step on the card) each is the plain op, or
returns its input as it came, so no value changes anywhere.
`record_redistributions` collects what each point did, for the dry run's
cell JSON.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

DATA_AXES = ("pod", "data")

_TRACE = threading.local()


@contextlib.contextmanager
def record_redistributions():
    """Collect {"point", "placements"} for every redistribution point
    that acted inside the block: the point's name (e.g. "fsdp", "q",
    "kv", "residual", "cache write") and what it left (e.g. "heads",
    "replicated")."""
    prev = getattr(_TRACE, "records", None)
    _TRACE.records = []
    try:
        yield _TRACE.records
    finally:
        _TRACE.records = prev


def _record(point: str, layout: str) -> None:
    records = getattr(_TRACE, "records", None)
    if records is not None:
        records.append({"point": point, "placements": layout})


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def _redistribute(t, placements):
    placements = tuple(placements)
    if tuple(t.placements) == placements:
        return t
    return t.redistribute(t.device_mesh, placements)


def _axis_index(mesh, name: str):
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


def gather_fsdp(tree):
    """`tree` (a dict / list of weights, or one weight) with every DTensor
    leaf's shards over "pod" / "data" replaced by replicas: the FSDP
    all-gather before use.  Plain tensors pass through."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_fsdp(v) for v in tree)
    if not is_dtensor(tree):
        return tree
    names = tree.device_mesh.mesh_dim_names or ()
    pl = [Replicate() if (isinstance(p, Shard) and names[i] in DATA_AXES)
          else p for i, p in enumerate(tree.placements)]
    out = _redistribute(tree, pl)
    if out is not tree:
        _record("fsdp", "replicated over data")
    return out


def _whole(placements, dims=None):
    """`placements` with each Partial (on mesh dims `dims`, default all)
    made Replicate."""
    return [Replicate() if p.is_partial() and (dims is None or i in dims)
            else p for i, p in enumerate(placements)]


class _AllReduce(torch.autograd.Function):
    """Partial placements (on mesh dims `dims`, default all) made
    Replicate: an all-reduce.  The gradient of a sum's parts is the
    gradient of the sum, so the backward hands it on whole, as
    Megatron's all-reduce does (its partial sums there reduced first).
    DTensor's own backward would hand on a Partial gradient, which its
    later ops gather in full, and which a MaskPartial (a sharded
    embedding's output) cannot take at all."""

    @staticmethod
    def forward(ctx, t, dims=None):
        ctx.dims = dims
        out = _redistribute(t, _whole(t.placements, dims))
        return out.view_as(out) if out is t else out

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, _whole(g.placements, ctx.dims)), None


class _GradPlaced(torch.autograd.Function):
    """The identity; the backward redistributes the gradient to the
    forward input's shards (replicated where the input is partial: the
    gradient of a sum's parts is the sum's)."""

    @staticmethod
    def forward(ctx, t):
        ctx.placements = _whole(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _redistribute(g, ctx.placements)


def grad_placed(t):
    """`t`; over a DTensor, its gradient arrives on t's shards (a
    replicated gradient is split while it is small).  A plain tensor is
    returned as it came."""
    if not is_dtensor(t) or not any(isinstance(p, Shard)
                                    for p in t.placements):
        return t
    _record("loss", "gradient placed as the forward")
    return _GradPlaced.apply(t)


def reduce_partial(t, point: str = "embedding"):
    """A DTensor's partial sums all-reduced (each Partial placement made
    Replicate); a plain tensor passes through."""
    if not is_dtensor(t) or not any(p.is_partial() for p in t.placements):
        return t
    _record(point, "all-reduced")
    return _AllReduce.apply(t, None)


def split_heads(t, n: int, d: int, point: str = "q"):
    """(..., n·d) -> (..., n, d).  On a DTensor whose last dim is sharded
    over mesh axes whose product does not divide n, those axes are
    replicated first (the view cannot split n unevenly); where it
    divides, the heads stay sharded.  A plain tensor is only reshaped."""
    if is_dtensor(t):
        mesh, last = t.device_mesh, t.ndim - 1
        dims = [i for i, p in enumerate(t.placements)
                if isinstance(p, Shard) and p.dim % t.ndim == last]
        ways = 1
        for i in dims:
            ways *= mesh.size(i)
        if dims:
            if n % ways:
                t = _redistribute(t, [Replicate() if i in dims else p
                                      for i, p in enumerate(t.placements)])
                _record(point, "replicated")
            else:
                _record(point, "heads")
    return t.reshape(*t.shape[:-1], n, d)


def merge_heads(t):
    """(..., n, d) -> (..., n·d).  On a DTensor whose heads are whole
    over "model", the flat dim is then sharded over "model" (a local
    slice, as the row-parallel projection that reads it would take it):
    made explicit, its backward all-gathers the gradient, so the
    gradient reaches the view whole (DTensor cannot unflatten an uneven
    head count).  A plain tensor is only reshaped."""
    t = t.reshape(*t.shape[:-2], t.shape[-2] * t.shape[-1])
    if not is_dtensor(t):
        return t
    i = _axis_index(t.device_mesh, "model")
    if (i is None or not t.placements[i].is_replicate()
            or t.shape[-1] % t.device_mesh.size(i)):
        return t
    pl = list(t.placements)
    pl[i] = Shard(t.ndim - 1)
    return _redistribute(t, pl)


def pick_last(t, index):
    """t[..., index[...]] along the last dim: torch.gather of a plain
    tensor.  Over a DTensor, the JAX package's masked sum
    sum(where(ids == index, t, 0)) (the same value: one term is nonzero)
    on each rank's shard, against its own range of the vocab ids with
    `index` placed as t's other dims, and its partial sums over a sharded
    vocab all-reduced (one number per row).  Left to DTensor, torch 2.11
    places the mask, and so t, whole over "data"."""
    if not is_dtensor(t):
        return torch.gather(t, -1, index.long()[..., None])[..., 0]
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    mesh, last = t.device_mesh, t.ndim - 1
    vocab = [isinstance(p, Shard) and p.dim % t.ndim == last
             for p in t.placements]
    if not is_dtensor(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    index = _redistribute(index, [Replicate() if v else p for v, p in
                                  zip(vocab, t.placements)])
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, mesh, t.placements)
    ids = torch.arange(offset[-1], offset[-1] + shape[-1], device=t.device)
    local = torch.where(ids == index.to_local()[..., None], t.to_local(),
                        0.0).sum(-1)
    out = DTensor.from_local(local, mesh, [Partial() if v else p for v, p
                                           in zip(vocab, t.placements)],
                             run_check=False, shape=t.shape[:-1],
                             stride=_contiguous_strides(t.shape[:-1]))
    return reduce_partial(out, "gold logit")


def _contiguous_strides(shape) -> tuple:
    strides, step = [], 1
    for n in reversed(shape):
        strides.append(step)
        step *= n
    return tuple(reversed(strides))


def logsumexp(t):
    """torch.logsumexp(t, -1) of a plain tensor; over a DTensor
    m + log(sum(exp(t - m))) with m the detached row max (the same value;
    the gradient does not depend on m)."""
    if not is_dtensor(t):
        return torch.logsumexp(t, dim=-1)
    m = t.detach().amax(-1, keepdim=True)
    m = _redistribute(m, _whole(m.placements))
    total = reduce_partial(torch.exp(t - m).sum(-1, keepdim=True),
                           "logsumexp")
    return (m + torch.log(total))[..., 0]


def put_rows(shape, indices, values):
    """A tensor of `shape` zeros (values' dtype) with out[indices] =
    values.  Over DTensors the indices and values are made whole, the put
    runs on each rank's local replica, and the result is replicated (the
    same values)."""
    if not is_dtensor(values):
        out = values.new_zeros(shape)
        out[indices] = values
        return out
    mesh = values.device_mesh
    whole = [Replicate()] * mesh.ndim

    def local(t):
        return _redistribute(t, whole).to_local() if is_dtensor(t) else t
    v = local(values)
    out = v.new_zeros(shape)
    out[tuple(local(i) for i in indices)] = v
    _record("moe dispatch", "replicated")
    return DTensor.from_local(out, mesh, whole, run_check=False)


def cumsum(t, dim: int):
    """torch.cumsum(t, dim).  Over a DTensor whose shards all lie on other
    dims, it runs on the local shard (its backward, a flip and a cumsum,
    has no DTensor strategy in torch 2.11)."""
    if not is_dtensor(t) or any(
            p.is_partial() or (isinstance(p, Shard)
                               and p.dim % t.ndim == dim % t.ndim)
            for p in t.placements) or not _even(t.shape, t.device_mesh,
                                                t.placements):
        return torch.cumsum(t, dim)
    return DTensor.from_local(torch.cumsum(t.to_local(), dim),
                              t.device_mesh, t.placements, run_check=False)


def batch_rows(t, n: int, j: int):
    """Microbatch j of n along dim 0: rows [j b/n, (j+1) b/n) of a plain
    tensor.  Over a DTensor sharded along dim 0 (evenly, n dividing each
    shard), the rows [j r/n, (j+1) r/n) of each rank's shard of r rows:
    the same microbatch size, every rank busy in each."""
    if is_dtensor(t) and any(isinstance(p, Shard) and p.dim == 0
                             for p in t.placements) and _even(
            t.shape, t.device_mesh, t.placements):
        local = t.to_local()
        if local.shape[0] % n == 0:
            rows = local.shape[0] // n
            return DTensor.from_local(local[j * rows:(j + 1) * rows],
                                      t.device_mesh, t.placements,
                                      run_check=False)
    rows = t.shape[0] // n
    return t[j * rows:(j + 1) * rows]


def index_copy_(dest, dim: int, index, source):
    """dest.index_copy_(dim, index, source), in place; returns dest.

    On a DTensor `dest`, `source` is first placed as `dest` is, but
    replicated over the mesh axes that shard `dim`, and each rank writes
    into its local shard the rows whose global index falls in it (an
    index outside the shard rewrites a row of the shard with its own
    value).  The values written are those of the plain call."""
    if not is_dtensor(dest):
        return dest.index_copy_(dim, index, source)
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)
    dim %= dest.ndim
    pl = list(dest.placements)
    split = [i for i, p in enumerate(pl) if isinstance(p, Shard)
             and p.dim == dim]
    src_pl = [Replicate() if i in split else p for i, p in enumerate(pl)]
    src = _redistribute(source, src_pl).to_local()
    idx = index.full_tensor() if is_dtensor(index) else index
    local = dest.to_local()
    shape, offset = compute_local_shape_and_global_offset(
        dest.shape, dest.device_mesh, pl)
    li = idx - offset[dim]
    inside = (li >= 0) & (li < shape[dim])
    li = li.clamp(0, max(shape[dim] - 1, 0))
    keep = local.index_select(dim, li)
    view = [1] * src.ndim
    view[dim] = -1
    local.index_copy_(dim, li, torch.where(inside.reshape(view),
                                           src.to(local.dtype), keep))
    _record("cache write", "rows of the local shard")
    return dest


def einsum(spec: str, *ops):
    """torch.einsum(spec, *ops); over DTensors, partitioned as the module
    docstring says (the same values)."""
    if not any(is_dtensor(o) for o in ops):
        return torch.einsum(spec, *ops)
    ins, out = spec.replace(" ", "").split("->")
    ins = ins.split(",")
    mesh = next(o for o in ops if is_dtensor(o)).device_mesh
    ops = [o if is_dtensor(o) else DTensor.from_local(
        o, mesh, [Replicate()] * mesh.ndim, run_check=False) for o in ops]
    local = True
    target = []                      # per mesh dim: the letter it shards
    for m in range(mesh.ndim):
        sizes: dict = {}
        for o, letters in zip(ops, ins):
            p = o.placements[m]
            if p.is_partial():
                local = False
            elif isinstance(p, Shard):
                lt = letters[p.dim]
                sizes[lt] = max(sizes.get(lt, 0), o.numel())
        if len(sizes) > 1:
            # keep the largest operand's shards, replicate the others
            keep = max(sizes, key=sizes.get)
            ops = [_redistribute(o, [Replicate() if (i == m and isinstance(
                p, Shard) and letters[p.dim] != keep) else p
                for i, p in enumerate(o.placements)])
                for o, letters in zip(ops, ins)]
            _record("einsum", "smaller operand replicated")
        lt = max(sizes, key=sizes.get) if sizes else None
        if lt is not None and lt not in out:
            local = False                # a contracted letter is sharded
        target.append(lt)

    def placed(letters):
        return [Shard(letters.index(lt)) if lt and lt in letters
                else Replicate() for lt in target]
    if not local or not all(_even(o.shape, mesh, placed(letters))
                            for o, letters in zip(ops, ins)):
        return torch.einsum(spec, *ops)
    ops = [_redistribute(o, placed(letters)) for o, letters in zip(ops, ins)]
    y = torch.einsum(spec, *(o.to_local() for o in ops))
    return DTensor.from_local(y, mesh, placed(out), run_check=False)


def _even(shape, mesh, placements) -> bool:
    """Whether each dim that `placements` shard splits evenly."""
    ways: dict = {}
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    return all(shape[d] % w == 0 for d, w in ways.items())


def on_local_shards(fn, q, *others):
    """fn(q, *others) for a function that is independent per batch row
    (dim 0) and head (dim 2) and returns a tensor of q's shape.  On
    DTensors: q keeps its shards on those dims (any other placement is
    made whole), the others are placed as q, fn runs on the local
    tensors, and the result takes q's placements (no collective beyond
    the placing).  Plain tensors: fn(q, *others)."""
    if not is_dtensor(q):
        return fn(q, *others)
    mesh = q.device_mesh
    pl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
          for p in q.placements]
    if not _even(q.shape, mesh, pl):
        return fn(q, *others)
    q = _redistribute(q, pl)
    others = [_redistribute(t, pl) for t in others]
    y = fn(q.to_local(), *(t.to_local() for t in others))
    return DTensor.from_local(y, q.device_mesh, pl, run_check=False)


def _batch_axes(rc) -> tuple:
    return tuple(a for a in rc.batch_axes.split(",") if a)


def _place(t, spec: dict):
    """Redistribute a DTensor so that tensor dim spec[axis] is sharded over
    each mesh axis named in `spec` (axes the mesh lacks are skipped) and
    it is replicated over every other mesh axis."""
    mesh = t.device_mesh
    pl = [Replicate()] * mesh.ndim
    for axis, dim in spec.items():
        i = _axis_index(mesh, axis)
        if i is not None:
            pl[i] = Shard(dim)
    return _redistribute(t, pl)


def constrain_qkv(q, k, v, rc):
    """The JAX package's q/k/v constraints (after rope, (b, s, h, d)):
    mode = rc.shard_attn or ("heads" if rc.shard_heads else "").
    "heads": q, k, v as P(batch, None, "model", None) (uneven head counts
    shard unevenly, where GSPMD pads); "seq": q as P(batch, "model",
    None, None), k and v as P(batch, None, None, None).  No mode, or
    plain tensors: returned as they came."""
    mode = rc.shard_attn or ("heads" if rc.shard_heads else "")
    if not mode or not is_dtensor(q):
        return q, k, v
    ba = {a: 0 for a in _batch_axes(rc)}
    if mode == "heads":
        spec = dict(ba, model=2)
        _record("qkv", "heads")
        return _place(q, spec), _place(k, spec), _place(v, spec)
    _record("qkv", "seq")
    return _place(q, dict(ba, model=1)), _place(k, ba), _place(v, ba)


def replicate_over_model(x):
    """A DTensor made whole over the "model" mesh axis (its partial sums
    there all-reduced, its shards there all-gathered), its placements
    over the other axes kept: the residual stream as GSPMD lays it out
    between tensor-parallel blocks (Megatron's pattern: column-parallel
    projections read it whole, row-parallel ones all-reduce into it).
    A plain tensor, or a mesh without "model", passes through."""
    if not is_dtensor(x):
        return x
    i = _axis_index(x.device_mesh, "model")
    if i is None:
        return x
    _record("residual", "replicated over model")
    if not isinstance(x.placements[i], Shard):
        # partial sums all-reduced, or (torch 2.11 reduces them in the
        # add that made x) whole already: either way the backward makes
        # the gradient whole, which DTensor leaves partial
        return _AllReduce.apply(x, (i,))
    pl = list(x.placements)
    pl[i] = Replicate()
    return _redistribute(x, pl)


def constrain_residual(x, rc):
    """The residual stream between blocks.  Under rc.sp_residual, the JAX
    package's constraint: (b, s, d) as P(batch, "model", None), the
    sequence over "model" (Megatron-style sequence parallelism).
    Without it, `replicate_over_model`.  A plain tensor is returned as it
    came."""
    if not is_dtensor(x):
        return x
    if not rc.sp_residual:
        return replicate_over_model(x)
    _record("residual", "sequence over model")
    return _place(x, dict({a: 0 for a in _batch_axes(rc)}, model=1))
