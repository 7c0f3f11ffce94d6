"""Spans: the device time of each section of the decode step, measured
inside the step itself, so that it survives CUDA-graph replay.

`span(name)` is a context manager the model code wraps its sections in
(`models/model.py:decode_step` and `_attn_step`, `models/moe.py:moe_apply`,
`models/layers.py:linear`).  While no recorder is armed it returns one
shared no-op object: no allocation, no event, no kernel.  While a
recorder is armed and marking, entry and exit each issue a mark: on the
card a one-thread kernel (`kernels/csrc/span_mark.cu`) on the current
stream, which reads the device's nanosecond timer and adds the time
since the previous mark to the slot of the span that was innermost when
the mark was issued (self time); on the CPU the same arithmetic on the
host clock.  A mark with no span open only sets the time, so the first
mark of a step (the root span's entry) starts the step's clock, and the
gap between two steps is charged to nothing.

The accumulator is an int64 tensor on the recorder's device, one slot
per name of `NAMES`.  `Recorder.open()` zeroes it and starts marking,
`close()` stops; it is read on the host once, by `disarm()`.  Nothing is
read per step.  Each mark takes its slot as a constant, so a mark
captured into a CUDA graph charges the same section on every replay.

With a recorder armed, each `serving.graphs.StepGraph` captures a second,
marked graph beside the plain one, and replays it while the recorder is
open (`active()`); the plain graph is the one an unarmed process
captures.  A recorder is armed before the steps are captured:

    rec = spans.arm("cuda")          # before the first step
    ...                              # captures: plain and marked twins
    rec.open(); <n steps>; rec.close()
    seconds = spans.disarm()         # {name: seconds over the n steps}
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import time

import torch

# the sections of the decode step; their self times sum to the step's
# in-graph device time
NAMES = ("decode.step",      # the root: embed, norms, RoPE, residuals, SiLU
         "attn.kv_write",    # this token's K/V into the cache
         "attn.gather",      # each slot's strip from the paged pool
         "attn.core",        # decode_attend: casts, GQA expand, softmax
         "proj",             # every `linear` but the expert contractions
         "moe.router",       # router matmul, softmax, top-k
         "moe.experts")      # expert contractions, gather, sum over k
SLOTS = {name: i for i, name in enumerate(NAMES)}


@functools.lru_cache(maxsize=None)
def _lib():
    """Compile (once per source hash) and load the mark kernel."""
    from .kernels.build import build_library
    return build_library("span_mark", span_mark_launch=[
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]).lib


def mark(acc, last, slot: int, clock=time.perf_counter_ns) -> None:
    """One mark: add the nanoseconds since the previous mark (`last[0]`,
    0 before the first) to `acc[slot]`, then set `last[0]` to now;
    `slot` < 0 only sets the time.  CUDA tensors: the mark kernel on the
    current stream, timed by the device's global timer; CPU tensors: the
    same on `clock`."""
    if acc.device.type == "cpu":
        now, prev = clock(), int(last[0])
        if slot >= 0 and prev:
            acc[slot] += now - prev
        last[0] = now
        return
    if acc.dtype != torch.int64 or last.dtype != torch.int64:
        raise TypeError("span marks keep int64 nanoseconds")
    stream = torch.cuda.current_stream(acc.device).cuda_stream
    rc = _lib().span_mark_launch(acc.data_ptr(), last.data_ptr(), slot,
                                 stream)
    if rc != 0:
        raise RuntimeError(f"span mark launch failed: CUDA error {rc}")


class Recorder:
    """The armed state: the accumulator and the previous mark's time on
    `device`, the slots of the open spans (innermost last), whether it
    marks, and `marks`, the marks issued so far (launched or captured)."""

    def __init__(self, device, clock=time.perf_counter_ns):
        self.device = torch.device(device)
        self.acc = torch.zeros(len(NAMES), dtype=torch.int64,
                               device=self.device)
        self.last = torch.zeros(1, dtype=torch.int64, device=self.device)
        self.clock = clock
        self.stack: list[int] = []
        self.active = False
        self.forced: bool | None = None
        self.marks = 0
        # one mark now, so the kernel is built and loaded before any
        # capture records it
        mark(self.acc, self.last, -1, clock)
        self.last.zero_()

    @property
    def marking(self) -> bool:
        return self.active if self.forced is None else self.forced

    def mark(self) -> None:
        mark(self.acc, self.last, self.stack[-1] if self.stack else -1,
             self.clock)
        self.marks += 1

    def open(self) -> None:
        """Zero the accumulator and start marking (at a step boundary)."""
        self.acc.zero_()
        self.last.zero_()
        self.active = True

    def close(self) -> None:
        """Stop marking (at a step boundary)."""
        self.active = False

    def seconds(self) -> dict[str, float]:
        """Seconds per name since `open()` (one read of the device)."""
        return {name: ns / 1e9
                for name, ns in zip(NAMES, self.acc.tolist())}


class _Span:
    __slots__ = ("rec", "slot")

    def __init__(self, rec: Recorder, slot: int):
        self.rec, self.slot = rec, slot

    def __enter__(self):
        self.rec.mark()                 # charges the enclosing span
        self.rec.stack.append(self.slot)
        return self

    def __exit__(self, *exc):
        self.rec.mark()                 # charges this span
        self.rec.stack.pop()
        return False


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()
_recorder: Recorder | None = None


def span(name: str):
    """A section named `name` (one of `NAMES`): marks at entry and exit
    while the armed recorder marks, else the shared no-op."""
    rec = _recorder
    if rec is None or not rec.marking:
        return NO_SPAN
    return _Span(rec, SLOTS[name])


def arm(device, clock=time.perf_counter_ns) -> Recorder:
    """Arm a recorder on `device` (on a card this builds the mark
    kernel).  Steps captured from now on get a marked twin."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a span recorder is already armed")
    _recorder = Recorder(device, clock)
    return _recorder


def disarm() -> dict[str, float]:
    """Disarm the recorder; returns its seconds per name (the one read
    of the accumulator)."""
    global _recorder
    rec, _recorder = _recorder, None
    if rec is None:
        raise RuntimeError("no span recorder is armed")
    rec.close()
    return rec.seconds()


def recorder() -> Recorder | None:
    """The armed recorder, or None."""
    return _recorder


def active() -> bool:
    """True while the armed recorder is open: the marked twins replay."""
    return _recorder is not None and _recorder.active


@contextlib.contextmanager
def forced(on: bool):
    """Mark (or not) inside the block whatever `active()` says: how a
    `StepGraph` captures its plain and its marked twin.  No-op while
    nothing is armed."""
    rec = _recorder
    if rec is None:
        yield
        return
    prev, rec.forced = rec.forced, on
    try:
        yield
    finally:
        rec.forced = prev
