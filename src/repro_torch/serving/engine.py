"""Serving engine: a fixed-batch session over one `DecodeCore`.

`ServeSession.kernel_plan` runs the What/When/Where planner over the
session's GEMMs.  With `quantize=True` the verdicts become the execution
policy: the plan is built before the first step and frozen into a static
`KernelPlanTable`, gated projection labels run the hand-written INT8 GEMM
kernel, ungated ones the plain torch matmul (prefill runs the same
per-token step under the prefill table).  `use_cim_for(label)` exposes
the per-GEMM gate; `route_report()` reports the route each label runs.
`make_prefill` is the full-sequence prefill forward under a plan table.
On a CUDA core every step of the session replays one captured CUDA graph
(`DecodeCore`); `decode_executables` / `prefill_executables` count them.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, RunConfig
from ..models import decode_step, forward, init_cache
from ..models.layers import CIM_ROUTE
from ..quant import KernelPlanTable
from .core import DecodeCore, sample_token


def make_serve_step(cfg: ModelConfig, rc: RunConfig,
                    plan: KernelPlanTable | None = None) -> Callable:
    """(params, cache, tokens, pos) -> (logits, cache) — one decode step
    gated by `plan`, run eagerly (the function `DecodeCore` captures)."""
    def step(params, cache, tokens, pos):
        return decode_step(params, cache, tokens, pos, cfg, rc, plan=plan)
    return step


def make_prefill(cfg: ModelConfig, rc: RunConfig,
                 plan: KernelPlanTable | None = None) -> Callable:
    """(params, tokens[, image_embeds]) -> logits — the prefill forward.

    Fills no cache (as in the JAX package).  Pass the *prefill* phase's
    plan table (DecodeCore.prefill_plan_table): each serving phase is gated
    by its own What/When/Where verdicts.  Runs under inference mode."""
    def run(params, tokens, image_embeds=None):
        with torch.inference_mode():
            logits, _ = forward(params, tokens, cfg, rc,
                                image_embeds=image_embeds, plan=plan)
        return logits
    return run


def cim_fraction(routes: dict) -> float:
    """Fraction of traced projection routes that run the CiM INT8 path
    (`cim-int8-pallas` only, as the JAX package counts it: the INT4 and
    FP8 kernel routes are not counted)."""
    vals = [r["route"] if isinstance(r, dict) else r
            for r in routes.values()]
    return sum(v == CIM_ROUTE for v in vals) / max(1, len(vals))


@dataclasses.dataclass
class ServeSession:
    """Minimal fixed-batch serving session (greedy or temperature
    sampling): all `batch` lanes advance in lockstep at one uniform
    position over one contiguous KV cache.

    quantize=True turns the planner verdicts into the execution policy
    (see DecodeCore) at weight `precision` ("int8", "int4" or "fp8");
    gated=False keeps the quantized weights but forces every label onto
    the standard path.  `device` defaults to "cuda"."""
    cfg: ModelConfig
    rc: RunConfig
    params: Any
    max_len: int
    batch: int
    quantize: bool = False
    gated: bool = True
    precision: str = "int8"
    device: Any = "cuda"

    def __post_init__(self):
        self.cache = None
        self.core = DecodeCore(self.cfg, self.rc, self.params,
                               quantize=self.quantize, gated=self.gated,
                               precision=self.precision,
                               plan_batch=self.batch,
                               plan_max_len=self.max_len, device=self.device)
        self.device = self.core.device
        self.params = self.core.params       # quantized if quantize=True
        self.plan_table = self.core.plan_table
        self.prefill_plan_table = self.core.prefill_plan_table
        self.reset()

    # --- planner plumbing: delegated to the core -----------------------

    @property
    def kernel_plan(self) -> dict:
        """label -> planner Decision for this session's decode GEMMs."""
        return self.core.kernel_plan

    @property
    def plan_cache_telemetry(self) -> dict:
        """The sweep engine's telemetry of this session's plan build."""
        return self.core.plan_cache_telemetry

    @property
    def verdict_table(self) -> KernelPlanTable:
        """This session's raw decode verdicts as a KernelPlanTable."""
        return self.core.verdict_table

    @property
    def phase_verdict_tables(self) -> dict:
        """phase -> raw-verdict KernelPlanTable."""
        return self.core.phase_verdict_tables

    def use_cim_for(self, label: str) -> bool:
        """The planner's "when" gate for one GEMM of this session."""
        return self.core.use_cim_for(label)

    def route_report(self) -> dict:
        """label -> {route, use_cim, what, where} as this session's decode
        step runs them (shape-only step, no compute)."""
        return self.core.route_report(self.batch, self.max_len)

    @property
    def decode_executables(self) -> int | None:
        """CUDA graphs captured for this session's decode step (exactly 1
        after any traffic); None on a CPU session, which runs eagerly."""
        return self.core.decode_executables

    @property
    def prefill_executables(self) -> int | None:
        """CUDA graphs captured for the prefill-phase step — see
        DecodeCore.prefill_executables."""
        return self.core.prefill_executables

    # --- request state --------------------------------------------------

    def reset(self) -> None:
        """Clear the KV cache and position for a fresh request.  The cache
        is zeroed in place, never reallocated: the core's CUDA graphs
        captured it by address."""
        if getattr(self, "cache", None) is None:
            self.cache = init_cache(self.cfg, self.rc, self.batch,
                                    self.max_len, device=self.device)
        else:
            for entry in self.cache:
                for t in entry.values():
                    t.zero_()
        self.pos = 0

    def prefill(self, tokens):
        """Feed a (batch, T) prompt token by token through the
        prefill-phase step; returns the last step's logits."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        logits = None
        for t in range(tokens.shape[1]):
            logits, self.cache = self.core.prefill_step(
                self.cache, tokens[:, t:t + 1], self.pos)
            self.pos += 1
        return logits

    def generate(self, prompt_tokens, n_new: int, temperature: float = 0.0,
                 seed: int = 0):
        """Prefill the prompt, then decode `n_new` tokens; returns them as
        a (batch, n_new) int64 tensor.  temperature > 0 samples from a
        torch.Generator on the session's device seeded with `seed`."""
        logits = self.prefill(prompt_tokens)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        tok = sample_token(self.cfg, logits, temperature, gen)
        for _ in range(n_new):
            out.append(tok)
            logits, self.cache = self.core.step(self.cache, tok, self.pos)
            self.pos += 1
            tok = sample_token(self.cfg, logits, temperature, gen)
        return torch.cat(out, dim=1)
