"""The frozen core of the serving stack.

`DecodeCore` owns everything that is fixed before the first request and
never changes while requests stream through: the model/run configs, the
(optionally INT8-, INT4- or FP8-quantized) parameters on one device, and
the What/When/Where verdicts as a static `KernelPlanTable` per serving
phase.
`ServeSession` (repro_torch.serving.engine) is a thin mutable shell over
one core.

The verdicts come from the batched planner (backend="vectorized") on the
sweep engine of the core's own device; `plan_cache_telemetry` reports
how much of that plan build the engine's result cache served.

The JAX package compiles the step once per plan and counts executables;
the port runs the step eagerly, so every step takes the routes of the
core's frozen tables.  A CUDA-graph capture of the step and the
continuous-batching step are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any

import torch

from ..configs.base import ModelConfig, RunConfig
from ..core.llm_workloads import is_projection_label, phase_gemms_of_model
from ..core.planner import plan_workload_by_phase
from ..core.sweep import default_engine, measured_cache_delta
from ..models import decode_step, init_cache
from ..models.layers import route_trace
from ..quant import (PRECISIONS, KernelPlanTable,
                     quantize_model_params_lowbit, strip_model_prefix)


def sample_token(cfg: ModelConfig, logits, temperature: float,
                 generator: torch.Generator | None = None):
    """Greedy / temperature sampling of the next token from step logits.
    Returns (b, 1) int64 tokens for feeding back into the decode step.

    Greedy decoding (temperature <= 0) takes the first maximum, as
    jnp.argmax does.  Temperature sampling draws from `generator`; it
    cannot give the JAX package's draws."""
    last = logits[:, -1]
    if temperature <= 0.0:
        tok = torch.argmax(last, dim=-1)
    else:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
    return tok[:, None].long()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif torch.is_tensor(tree):
        yield tree


def _meta(tree):
    """The same tree with every tensor as a shape-only "meta" tensor."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_meta(v) for v in tree]
    return tree.to("meta") if torch.is_tensor(tree) else tree


@dataclasses.dataclass
class DecodeCore:
    """Frozen core: params + plan tables on one device.

    quantize=True turns the planner verdicts into the execution policy:
    the kernel plan is built eagerly, then projection weights are
    quantized at `precision` ("int8", "int4" or "fp8": the runtime What
    axis, `quant.quantize_model_params_lowbit`); gated labels then run
    the INT8 GEMM kernel (INT4 unpacked to int8 first, FP8 as an e4m3
    operand).  gated=False keeps the quantized weights but forces every
    label onto the standard path — the parity baseline for the gated
    program.  An unknown precision raises ValueError.

    `device` defaults to "cuda"; the params must already live there (a
    CPU run passes device="cpu" explicitly)."""
    cfg: ModelConfig
    rc: RunConfig
    params: Any
    quantize: bool = False
    gated: bool = True
    # weight precision of the quantized path: "int8" | "int4" | "fp8"
    precision: str = "int8"
    # decode shape the planner reasons about (ServeSession passes its own)
    plan_batch: int = 8
    plan_max_len: int = 1024
    device: Any = "cuda"

    def __post_init__(self):
        if self.quantize and self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r} "
                             "(expected int8/int4/fp8)")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DecodeCore runs on 'cuda' by default and this "
                               "torch has no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        for leaf in _leaves(self.params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params live on {leaf.device}, the core "
                                 f"runs on {self.device}")
        self._kernel_plan = None
        self._kernel_plans = None
        self._plan_cache_telemetry = None
        self._plan_lock = threading.Lock()
        self._verdict_table = None
        self._phase_verdict_tables = None
        self.plan_table = None
        self.prefill_plan_table = None
        if self.quantize:
            # plan BEFORE the first step: each serving phase gets its own
            # table (prefill GEMMs carry M = seq_len reuse, decode GEMMs
            # collapse to M = batch)
            tables = self.phase_verdict_tables
            table, ptable = tables["decode"], tables["prefill"]
            self.plan_table = table if self.gated else table.ungated()
            pgate = ptable if self.gated else ptable.ungated()
            # when the phases gate every *projection* identically, share
            # one table; activation GEMMs (QK^T / pV) never consult it
            proj_flips = [lab for lab in self.plan_table.flips(pgate)
                          if is_projection_label(lab)]
            self.prefill_plan_table = (pgate if proj_flips
                                       else self.plan_table)
            self.params = quantize_model_params_lowbit(self.params,
                                                       self.precision)

    # --- planner plumbing ----------------------------------------------

    @property
    def kernel_plan(self) -> dict:
        """label -> planner Decision for this core's decode GEMMs, built
        lazily (once, under a lock) by the batched planner on the core's
        device; the engine's result cache makes repeat cores over the
        same shapes free."""
        if self._kernel_plan is None:
            with self._plan_lock:
                if self._kernel_plan is None:
                    self._build_kernel_plan()
        return self._kernel_plan

    def _build_kernel_plan(self) -> None:
        # plan BOTH serving phases: decode GEMMs at M = plan_batch and
        # prefill GEMMs at M = plan_max_len
        phases = phase_gemms_of_model(self.cfg, self.plan_max_len,
                                      self.plan_batch)
        engine = default_engine(self.device)
        by_phase, self._plan_cache_telemetry = measured_cache_delta(
            lambda: plan_workload_by_phase(phases, backend="vectorized",
                                           engine=engine), engine)
        self._kernel_plans = {ph: {d.gemm.label: d for d in ds}
                              for ph, ds in by_phase.items()}
        self._kernel_plan = self._kernel_plans["decode"]

    @property
    def plan_cache_telemetry(self) -> dict:
        """The sweep engine's telemetry of this core's plan build
        (triggers the build on first access): how many of the verdict
        lookups the result cache served (`plan_hits`) and how many were
        evaluated (`plan_misses`), plus the engine-wide `cache_info()`."""
        _ = self.kernel_plan
        return self._plan_cache_telemetry

    @property
    def kernel_plans(self) -> dict:
        """phase -> {label -> Decision} for both serving phases."""
        _ = self.kernel_plan
        return self._kernel_plans

    @property
    def phase_verdict_tables(self) -> dict[str, KernelPlanTable]:
        """phase -> raw-verdict KernelPlanTable (never force-ungated)."""
        if self._phase_verdict_tables is None:
            self._phase_verdict_tables = {
                ph: KernelPlanTable.from_decisions(
                    plan.values(), model_name=self.cfg.name)
                for ph, plan in self.kernel_plans.items()}
        return self._phase_verdict_tables

    @property
    def verdict_table(self) -> KernelPlanTable:
        """The decode-phase raw verdicts as a KernelPlanTable."""
        if self._verdict_table is None:
            self._verdict_table = self.phase_verdict_tables["decode"]
        return self._verdict_table

    def use_cim_for(self, label: str) -> bool:
        """The planner's "when" gate for one GEMM.  Accepts full
        ("<model> Wq") or short ("Wq") labels; unknown labels raise
        KeyError with the known-label list."""
        return self.verdict_table.use_cim(
            strip_model_prefix(label, self.cfg.name))

    # --- the two steps ---------------------------------------------------

    def step(self, cache, tokens, pos):
        """Fixed-batch decode step (uniform position), gated by the
        decode plan; updates `cache` in place."""
        with torch.inference_mode():
            return decode_step(self.params, cache, tokens, pos, self.cfg,
                               self.rc, plan=self.plan_table)

    def prefill_step(self, cache, tokens, pos):
        """The prefill-phase per-token step: the same decode step gated by
        the *prefill* plan table."""
        with torch.inference_mode():
            return decode_step(self.params, cache, tokens, pos, self.cfg,
                               self.rc, plan=self.prefill_plan_table)

    def route_report(self, batch: int, max_len: int) -> dict:
        """label -> {route, use_cim, what, where} as the decode step runs
        them, from one step on "meta" tensors (shapes only, no compute,
        no kernel launch)."""
        cache = init_cache(self.cfg, self.rc, batch, max_len, device="meta")
        tokens = torch.zeros((batch, 1), dtype=torch.long, device="meta")
        with route_trace() as records, torch.inference_mode():
            decode_step(_meta(self.params), cache, tokens, 0, self.cfg,
                        self.rc, plan=self.plan_table)
        report = {}
        for r in records:
            entry = (self.plan_table.entry(r["label"])
                     if self.plan_table is not None else None)
            report[r["label"]] = {
                "route": r["route"],
                "use_cim": entry.use_cim if entry else False,
                "what": entry.what if entry else "baseline",
                "where": entry.where if entry else "PE"}
        return report
