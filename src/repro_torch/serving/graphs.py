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

A capture that fails raises: nothing falls back to running `fn` eagerly.

The kernels' launch counters (`int8_gemm.launches`, `launches_by_design`,
`launches_by_format`, and the attention kernels' counters) are Python
integers that a replay does not move.  A `StepGraph` records what its
capture launched, takes those counts back out (a capture launches
nothing), and adds them again on every replay, so a replayed step counts
exactly as the eager step does.

`capture_lock` is held by every capture.  In CUDA's default (global)
capture mode no thread of the process may make a call that syncs or
copies to or from the host while any stream captures; the plan service's
background refreshes run planner work on the card, so they hold the same
lock, and a capture and a refresh never overlap
(`repro_torch.core.plan_service`).
"""
from __future__ import annotations

import threading

import torch

capture_lock = threading.Lock()

# kernel wrappers (attributes of repro_torch.kernels) whose counters a
# replay credits
COUNTED_KERNELS = ("int8_gemm", "flash_attention", "decode_attention")


def _wrappers():
    from .. import kernels
    return [getattr(kernels, name) for name in COUNTED_KERNELS]


def _counter_dicts(wrapper) -> list[dict]:
    return [wrapper.launches_by_design,
            getattr(wrapper, "launches_by_format", {})]


def _snapshot() -> list:
    return [(w.launches, [dict(d) for d in _counter_dicts(w)])
            for w in _wrappers()]


def _delta(after: list, before: list) -> list:
    return [(a - b, [{k: da[k] - db[k] for k in da}
                     for da, db in zip(dicts_a, dicts_b)])
            for (a, dicts_a), (b, dicts_b) in zip(after, before)]


def _add(delta: list, sign: int = 1) -> None:
    for w, (n, dicts) in zip(_wrappers(), delta):
        w.launches += sign * n
        for counts, d in zip(_counter_dicts(w), dicts):
            for k, v in d.items():
                counts[k] += sign * v


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

    def _static(self, x):
        if torch.is_tensor(x):
            return x.clone()
        return torch.full((), x, dtype=torch.long, device="cuda")

    def _capture(self, inputs) -> None:
        static = [self._static(x) for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.fn(*static)                    # warm-up, launched for real
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = _snapshot()
        try:
            with capture_lock:
                with torch.cuda.graph(graph):
                    out = self.fn(*static)
        except Exception as e:
            _add(_delta(_snapshot(), before), -1)
            raise RuntimeError(
                "CUDA-graph capture of the step failed (the step does not "
                f"run eagerly instead): {e}") from e
        self.credit = _delta(_snapshot(), before)
        _add(self.credit, -1)              # the capture launched nothing
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
        self.graph.replay()
        _add(self.credit)
        return self.static_out.clone()
