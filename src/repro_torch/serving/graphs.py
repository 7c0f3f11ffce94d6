"""A step function captured once as a CUDA graph and replayed.

`StepGraph(fn)` is the port's counterpart of one jitted executable of the
JAX package.  Its first call warms `fn` up on a side stream (where nvcc
builds the kernels at first use and lazy workspaces are allocated: none
of that may happen inside a capture), then captures one call of `fn` on
static copies of the inputs and replays it; every later call copies its
inputs into those static tensors (`copy_`, or `fill_` for a Python
number) and replays.  What `fn` closes over, such as the model's
parameters and the KV cache, is captured by address: the caller keeps it
alive and updates it in place (`keep=` holds a reference so that memory
is never freed under the graph).  Temporaries of the step (the INT8
GEMM's split-K partials, INT4's unpacked weights) come from the graph's
private memory pool, so their addresses stay fixed.

The warm-up runs `fn` for real, and `fn` updates what it closes over in
place.  Writing a KV row again is idempotent, but advancing a mamba
slot's SSM state and conv carry is not, so the tensors of `keep` are
copied before the warm-up and restored after it: the first call applies
the step once, as every later replay does.

A capture that fails raises: nothing falls back to running `fn` eagerly.
Python's cyclic garbage collector is run before each capture and held
off during it: a dead CUDA graph left in a reference cycle (a discarded
core and its steps) would otherwise be freed at whatever allocation
triggers a collection, and destroying a graph while a stream captures
invalidates that capture (torch's `torch.cuda.graph` no longer collects
on entry).

The kernels' launch counters are Python integers that a replay does not
move.  A `StepGraph` records what its capture launched in the counters of
the launch registry (`repro_torch.kernels.launch`), takes those counts
back out (a capture launches nothing), and adds them again on every
replay, so a replayed step counts exactly as the eager step does.

With a span recorder armed (`repro_torch.spans`), the first call also
captures a marked twin: the same step with the span marks in it, in the
plain graph's memory pool (each replay's output is copied out at once,
so the twins' temporaries may share addresses).  The marked twin
replays while that recorder is open, the plain graph at every other
time; both credit the same launch counts, and `marks` is the marks one
marked replay issues.  With nothing armed, nothing else is captured.

`capture_lock` is held by every capture.  In CUDA's default (global)
capture mode no thread of the process may make a call that syncs or
copies to or from the host while any stream captures; the plan service's
background refreshes run planner work on the card, so they hold the same
lock, and a capture and a refresh never overlap
(`repro_torch.core.plan_service`).
"""
from __future__ import annotations

import gc
import threading

import torch

from .. import spans
from ..kernels import launch
from ..tree import leaves

capture_lock = threading.Lock()


class StepGraph:
    """`fn(*inputs) -> tensor`, captured once as a CUDA graph on the
    first call and replayed on every call (see the module docstring).

    Inputs are CUDA tensors (copied into the static inputs) or Python
    numbers (filled into 0-d int64 static inputs, no host-to-device
    copy).  The result is a fresh copy of the graph's output, so a caller
    may hold it across later replays.  `captures` is 1 once the graph
    exists; `credit` holds the launch counts one replay adds."""

    def __init__(self, fn, keep=None):
        self.fn = fn
        self.keep = keep
        self.graph = None
        self.static_in: list = []
        self.static_out = None
        self.credit: list | None = None
        self.captures = 0
        self.marked = self.marked_out = self.marked_by = None
        self.marks = 0

    def _static(self, x):
        if torch.is_tensor(x):
            return x.clone()
        return torch.full((), x, dtype=torch.long, device="cuda")

    def _record(self, static, pool=None):
        """Capture one call of `fn` on `static` into a new graph (in the
        memory pool `pool`, or a private one): (graph, out, credit)."""
        graph = torch.cuda.CUDAGraph()
        before = launch.snapshot()
        collecting = gc.isenabled()
        gc.collect()                       # dead graphs go before, not during
        gc.disable()
        try:
            with capture_lock:
                with torch.cuda.graph(graph, pool=pool):
                    out = self.fn(*static)
        except Exception as e:
            launch.credit(launch.since(before), sign=-1)
            raise RuntimeError(
                "CUDA-graph capture of the step failed (the step does not "
                f"run eagerly instead): {e}") from e
        finally:
            if collecting:
                gc.enable()
        credit = launch.since(before)
        launch.credit(credit, sign=-1)     # the capture launched nothing
        return graph, out, credit

    def _capture(self, inputs) -> None:
        static = [self._static(x) for x in inputs]
        kept = list(leaves(self.keep))
        saved = [t.clone() for t in kept]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with spans.forced(False), torch.cuda.stream(side):
            self.fn(*static)                    # warm-up, launched for real
        torch.cuda.current_stream().wait_stream(side)
        for t, old in zip(kept, saved):         # undo the warm-up's update
            t.copy_(old)
        del saved
        with spans.forced(False):
            graph, out, self.credit = self._record(static)
        rec = spans.recorder()
        if rec is not None:
            marks = rec.marks
            with spans.forced(True):
                marked, marked_out, credit = self._record(static,
                                                          graph.pool())
            if credit != self.credit:
                raise RuntimeError("the marked twin of the step launched "
                                   "other kernels than the plain step")
            self.marked, self.marked_out = marked, marked_out
            self.marked_by, self.marks = rec, rec.marks - marks
        self.graph, self.static_in, self.static_out = graph, static, out
        self.captures += 1

    def __call__(self, *inputs):
        if self.graph is None:
            self._capture(inputs)
        for dst, src in zip(self.static_in, inputs):
            if torch.is_tensor(src):
                if src is not dst:
                    dst.copy_(src, non_blocking=True)
            else:
                dst.fill_(src)
        graph, out = self.graph, self.static_out
        if self.marked is not None and spans.recorder() is self.marked_by \
                and spans.active():
            graph, out = self.marked, self.marked_out
        graph.replay()
        launch.credit(self.credit)
        return out.clone()
