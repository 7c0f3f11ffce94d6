"""What one rank of a traced step does: its collectives (bytes by type),
an op census, its FLOPs, the bytes its ops read and write, and the peak
of its live intermediates (the counterpart of the JAX package's
`launch/hlo_analysis.py`).

The JAX package parses XLA's partitioned, per-device HLO text.  Torch
has no HLO: the port reads the ops a step dispatches on this rank.
`StepRecorder` is a `TorchDispatchMode` that lets DTensor desugar each op
first (it returns NotImplemented for an op on DTensors, as
`CommDebugMode` does) and so sees only local ops on this rank's shards:
the c10d functional collectives DTensor issues, and the aten ops of its
local compute.  Each becomes an `OpRecord`.

* `collective_stats(records)` — the JAX package's dict: result bytes of
  each collective x the traffic factor (all-reduce 2, the others 1),
  summed, and {op: {"count", "bytes"}} by type under XLA's names
  (all-reduce, all-gather, reduce-scatter, all-to-all,
  collective-permute).  An all_to_all_single with one nonzero input and
  one nonzero output split is a permute (funcol's `permute_tensor`).
  A CPU mesh (the fake and gloo groups) has no all-to-all: DTensor issues
  an all-gather plus a chunk in its place, and that is what is counted.
* `op_census(records)` — counts under the JAX package's keys: "dot"
  (mm, bmm, addmm, baddbmm), "convolution", "transpose" (transpose,
  permute, t), "reshape" (view, _unsafe_view, reshape, unflatten), "copy"
  (copy_, _to_copy, clone).  Eager torch fuses nothing, so "fusion" is 0.

FLOPs come from `torch.utils.flop_counter`'s formulas on each local op's
shapes, so they are per rank (a FlopCounterMode over DTensors would count
the global op).  Bytes accessed sum each local op's tensor inputs and
outputs, views and collectives excluded: the counterpart of XLA's
"bytes accessed" for an unfused program.  The ops DTensor's sharding
propagation runs on global-shape fake tensors (to learn an output's
shape) are not this rank's and are skipped.  The peak of live intermediates
tracks every storage a local op or a collective creates (an all-gathered
weight, say), from its creation until the last tensor on it is freed;
storages that exist before the step (its arguments) are not counted.
"""
from __future__ import annotations

import collections
import weakref

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_TRAFFIC_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0,
                   "reduce-scatter": 1.0, "all-to-all": 1.0,
                   "collective-permute": 1.0}

# the c10d functional collectives (what DTensor issues), under XLA's names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}

_CENSUS = {
    "dot": ("mm", "bmm", "addmm", "baddbmm"),
    "convolution": ("convolution", "_convolution", "convolution_backward"),
    "transpose": ("transpose", "permute", "t"),
    "reshape": ("view", "_unsafe_view", "reshape", "unflatten"),
    "copy": ("copy_", "_to_copy", "clone"),
}

_FAKE = torch._C._TorchDispatchModeKey.FAKE

OpRecord = collections.namedtuple(
    "OpRecord", "op collective result_bytes io_bytes flops")
OpRecord.__doc__ = """One local op: `op` its aten name without overload
("mm", "all_gather_into_tensor"), `collective` XLA's name of it or None,
`result_bytes` its result's bytes, `io_bytes` the bytes it reads and
writes (0 for a view or a collective), `flops` its FLOPs."""


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _collective(func, args) -> str | None:
    if func.namespace != "_c10d_functional":
        return None
    name = _COLLECTIVE_OPS.get(func._overloadpacket.__name__)
    if name == "all-to-all":
        out_splits, in_splits = args[1], args[2]
        if (out_splits and in_splits
                and sum(1 for s in out_splits if s) == 1
                and sum(1 for s in in_splits if s) == 1):
            return "collective-permute"
    return name


class StepRecorder(TorchDispatchMode):
    """Records every local op dispatched inside the mode (see the module
    docstring).  After the block: `records` (OpRecords in dispatch order),
    `flops`, `bytes_accessed` and `peak_temp_bytes`."""

    def __init__(self):
        super().__init__()
        self.records: list[OpRecord] = []
        self._live: dict = {}            # storage key -> [bytes, tensors]
        self._live_bytes = 0
        self.peak_temp_bytes = 0
        self._seen_before: set = set()

    def exclude(self, tree) -> None:
        """Storages of `tree` (the step's arguments) are not intermediates:
        an op that writes them in place adds nothing to the peak."""
        for t in _tensors(tree):
            t = getattr(t, "_local_tensor", t)
            self._seen_before.add(_storage_key(t))

    @property
    def flops(self) -> int:
        return sum(r.flops for r in self.records)

    @property
    def bytes_accessed(self) -> int:
        return sum(r.io_bytes for r in self.records)

    def _track(self, out) -> None:
        for t in _tensors(out):
            key = _storage_key(t)
            if key is None or key in self._seen_before:
                continue
            entry = self._live.get(key)
            if entry is None:
                nbytes = t.untyped_storage().nbytes()
                entry = self._live[key] = [nbytes, 0]
                self._live_bytes += nbytes
                self.peak_temp_bytes = max(self.peak_temp_bytes,
                                           self._live_bytes)
            entry[1] += 1
            weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self._live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self._live_bytes -= entry[0]
            del self._live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented           # let DTensor desugar it first
        if torch._C._get_dispatch_mode(_FAKE) is not None:
            # DTensor's sharding propagation runs each new op once on
            # global-shape fake tensors to learn its output's metadata:
            # not this rank's compute
            return func(*args, **kwargs)
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        if func.namespace == "_c10d_functional":
            # a collective's result is a new storage; wait_tensor and
            # _wrap_tensor_autograd (an AsyncCollectiveTensor around it)
            # hand that storage on
            coll = _collective(func, args)
            if coll is not None:
                self.records.append(OpRecord(name, coll, _nbytes(out), 0,
                                             0))
                self._track(out)
            return out
        flops = 0
        if packet in flop_registry:
            flops = int(flop_registry[packet](*args, **kwargs, out_val=out))
        io = 0 if func.is_view else _nbytes((args, kwargs)) + _nbytes(out)
        self.records.append(OpRecord(name, None, _nbytes(out), io, flops))
        self._track(out)
        return out


def _storage_key(t):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return None


def collective_stats(records) -> dict:
    """Returns {"collective_bytes": float, "by_type": {op: {count, bytes}}}.

    `collective_bytes` = sum over collectives of result bytes x traffic
    factor — the per-rank payload crossing links (the JAX package's
    metric, with its factors)."""
    by_type: dict = collections.defaultdict(lambda: {"count": 0,
                                                     "bytes": 0.0})
    total = 0.0
    for r in records:
        if r.collective is None:
            continue
        by_type[r.collective]["count"] += 1
        by_type[r.collective]["bytes"] += r.result_bytes
        total += r.result_bytes * _TRAFFIC_FACTOR[r.collective]
    return {"collective_bytes": total,
            "by_type": {k: dict(v) for k, v in by_type.items()}}


def op_census(records, ops=("fusion", "dot", "convolution", "transpose",
                            "reshape", "copy")) -> dict:
    """Counts of the local ops under the JAX package's HLO op keys (see the
    module docstring); "fusion" is 0 in eager torch."""
    names = collections.Counter(r.op for r in records if r.collective is None)
    return {op: sum(names[n] for n in _CENSUS.get(op, ())) for op in ops}
