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
from ..models import decode_step, forward, init, init_cache
from ..models.layers import CIM_ROUTE
from ..quant import KernelPlanTable, quantize_model_params
from .core import DecodeCore, meta_route_records, sample_token


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
    by its own What/When/Where verdicts.  Runs under inference mode, in
    a host range named "prefill.forward" that a running torch.profiler
    records beside its device activities, on their clock.  The range is
    an op-scoped record (`_RecordFunctionFast`), not
    `torch.profiler.record_function`: a user annotation would also put
    a device-side copy of the range among the device's activities, over
    every idle gap inside the forward."""
    def run(params, tokens, image_embeds=None):
        with torch.inference_mode(), \
                torch._C._profiler._RecordFunctionFast("prefill.forward"):
            logits, _ = forward(params, tokens, cfg, rc,
                                image_embeds=image_embeds, plan=plan)
        return logits
    return run


def decode_routes(cfg: ModelConfig, rc: RunConfig, plan: KernelPlanTable,
                  batch: int, max_len: int,
                  n_image_tokens: int = 0) -> dict:
    """label -> executed route of the plan-gated decode step.

    Builds the INT8-quantized params and the cache on "meta" (no storage,
    so full production configs fit) and runs the step once under
    `route_trace`: the route each projection label takes, as the step on
    the card runs it (`serving.core.meta_route_records`, as
    `DecodeCore.route_report`).  Used by the dry run's decode cells."""
    params = quantize_model_params(init(torch.Generator(), cfg,
                                        device="meta"))
    records = meta_route_records(cfg, rc, params, plan, batch, max_len,
                                 n_image_tokens)
    return {r["label"]: r["route"] for r in records}


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
    the standard path.  `device` defaults to "cuda".

    An audio session takes (batch, T, nb) prompts and generates (batch,
    n_new, nb) tokens.  A vlm session holds `n_image_tokens` rows of
    bf16 image K/V per cross slot; as in the JAX package, nothing fills
    them, so its decode steps attend to zeros."""
    cfg: ModelConfig
    rc: RunConfig
    params: Any
    max_len: int
    batch: int
    n_image_tokens: int = 0
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
        return self.core.route_report(self.batch, self.max_len,
                                      self.n_image_tokens)

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
                                    self.max_len, device=self.device,
                                    n_image_tokens=self.n_image_tokens)
        else:
            for entry in self.cache:
                for t in entry.values():
                    t.zero_()
        self.pos = 0

    def prefill(self, tokens):
        """Feed a (batch, T) prompt (audio: (batch, T, nb)) token by token
        through the prefill-phase step; returns the last step's logits."""
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
        a (batch, n_new) int64 tensor (audio: (batch, n_new, nb)).
        temperature > 0 samples from a torch.Generator on the session's
        device seeded with `seed`."""
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
