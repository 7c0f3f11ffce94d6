"""The one launch path of the kernel wrappers, written once: a wrapper
keeps only its shape and dtype contract, its plan, its C call and its
plain version.

`refuse_autograd` stops a forward-only kernel where autograd would
record.  `device` gives the inputs' one device: a wrapper takes its plain
version on "cpu", an empty result on "meta" and its kernel on "cuda".
`run` calls the C launcher on the current stream's raw handle, checks
its return code and bumps the counters that `counted` gave the wrapper:
`launches`, `launches_by_design` and, with formats, `launches_by_format`.

A CUDA graph's replay moves no Python counter, so `serving.graphs.
StepGraph` takes a `snapshot()` of the wrappers in REGISTRY around a
capture and `credit()`s the difference on each replay.  `sweep_eval`
counts but stays out of REGISTRY: the plan service launches it from a
thread of its own, which no capture may credit.
"""
from __future__ import annotations

import torch

# the wrappers whose launches a replayed CUDA graph credits
REGISTRY: list = []


def counted(*designs: str, formats: tuple = (), registered: bool = True):
    """Decorator: give a wrapper its counters (zeroed) for `designs` and
    `formats`, and add it to REGISTRY if `registered`."""
    def wrap(wrapper):
        wrapper.launches = 0
        wrapper.launches_by_design = dict.fromkeys(designs, 0)
        if formats:
            wrapper.launches_by_format = dict.fromkeys(formats, 0)
        if registered:
            REGISTRY.append(wrapper)
        return wrapper
    return wrap


def refuse_autograd(name: str, *tensors) -> None:
    """Raise if autograd would record through a forward-only kernel: its
    output would carry no grad_fn and the inputs' gradients would be lost
    without an error.  Checked before the device dispatch, so the plain
    version on the CPU refuses too."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward (the JAX package cannot "
            f"differentiate its Pallas kernel either); call it under "
            f"torch.no_grad() or torch.inference_mode(), or train with "
            f"attn_impl='flash_jnp' or 'naive'")


def device(name: str, what: str, *tensors) -> torch.device:
    """The device that `tensors` (named `what` in the error) share, one of
    cuda, cpu and meta.  Raises ValueError where they differ or where it
    is another."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"{what} must share a device; got "
                             + ", ".join(str(t.device) for t in tensors))
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"{name} runs on cuda (or cpu/meta), got {dev}")
    return dev


def run(wrapper, dev: torch.device, fn, *args, designs: tuple,
        formats: tuple = ()) -> None:
    """Launch `fn(*args, stream)` on the current stream of the card `dev`,
    raise RuntimeError on a nonzero return code, then count one launch of
    `wrapper` per name in `designs` and one per name in `formats`."""
    cur = torch._C._cuda_getDevice()
    if dev.index != cur:
        with torch.cuda.device(dev):
            return run(wrapper, dev, fn, *args, designs=designs,
                       formats=formats)
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(cur))
    if rc != 0:
        raise RuntimeError(
            f"{wrapper.__name__} ({'+'.join(designs)}) launch failed: CUDA "
            f"error {rc}" + (" (10000 + n: CUresult n of a TMA descriptor)"
                             if rc >= 10000 else ""))
    wrapper.launches += len(designs)
    for d in designs:
        wrapper.launches_by_design[d] += 1
    for f in formats:
        wrapper.launches_by_format[f] += 1


def _cells(wrappers):
    """(dict, key) of every count of `wrappers`: `launches` (an attribute,
    so in the function's `__dict__`), then per design and per format."""
    for w in wrappers:
        yield vars(w), "launches"
        for counts in (w.launches_by_design,
                       getattr(w, "launches_by_format", {})):
            for key in counts:
                yield counts, key


def snapshot(wrappers=REGISTRY) -> list[int]:
    """Every count of `wrappers` (default: the registry), in a fixed
    order."""
    return [counts[key] for counts, key in _cells(wrappers)]


def since(before: list[int], wrappers=REGISTRY) -> list[int]:
    """What each count of `wrappers` gained since the snapshot `before`."""
    return [now - then for now, then in zip(snapshot(wrappers), before)]


def credit(delta: list[int], wrappers=REGISTRY, sign: int = 1) -> None:
    """Add `sign` times `delta` (from `since`) to the counts of
    `wrappers`."""
    for (counts, key), n in zip(_cells(wrappers), delta):
        counts[key] += sign * n
