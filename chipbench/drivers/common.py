"""What the drivers share: the program's configuration objects built from
a configuration file, the profiler window of a traced run, and handing
the card's memory back before the reference runs."""
from __future__ import annotations

import gc
import sys
import time

import torch


T0 = time.perf_counter()


def log(msg: str) -> None:
    """A progress line on standard error, stamped with the seconds since
    the harness was loaded."""
    print(f"[{time.perf_counter() - T0:.3f} s] {msg}", file=sys.stderr,
          flush=True)


def warm_profiler(device) -> None:
    """Start and stop the profiler once, so that a traced window does not
    pay the profiler's first start (its CUDA activity set-up) inside."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts):
        torch.zeros(1, device=device).add_(1)
        sync(device)


def program_config(model: dict):
    """The program's ModelConfig from a configuration's "model" block:
    a field given as a dict (moe, ssm, vision, audio, ...) becomes the
    dataclass that the field's type names."""
    import dataclasses
    import typing
    from repro_torch.configs import ModelConfig
    hints = typing.get_type_hints(ModelConfig)
    fields = dict(model)
    for f in dataclasses.fields(ModelConfig):
        if isinstance(fields.get(f.name), dict):
            kind = next(t for t in typing.get_args(hints[f.name])
                        or (hints[f.name],) if dataclasses.is_dataclass(t))
            fields[f.name] = kind(**fields[f.name])
    return ModelConfig(**fields)


def run_config(cell: dict):
    from repro_torch.configs import RunConfig
    return RunConfig(**cell["run_config"])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def release() -> None:
    """Collect what the caller dropped and return the card's cached
    blocks, so the reference starts from the memory it needs."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class TraceWindow:
    """torch.profiler over part of the measured window, opened and closed
    at a synchronised device, so that the device work inside it is what
    the host issued between the two."""

    def __init__(self, device, start_at: float, stop_at: float):
        self.device = torch.device(device)
        self.start_at, self.stop_at = start_at, stop_at
        self.prof = None
        self.t0 = self.t1 = None

    def poll(self, now: float) -> str | None:
        """Open or close the window when its time has come; returns
        "start" or "stop" when it did."""
        if self.prof is None and now >= self.start_at:
            self.start()
            return "start"
        if self.t0 is not None and self.t1 is None and now >= self.stop_at:
            self.stop()
            return "stop"
        return None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        sync(self.device)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self) -> None:
        sync(self.device)
        self.t1 = time.perf_counter()
        self.prof.__exit__(None, None, None)

    @property
    def closed(self) -> bool:
        return self.t1 is not None
