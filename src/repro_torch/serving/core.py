"""The frozen core of the serving stack.

`DecodeCore` owns everything that is fixed before the first request and
never changes while requests stream through: the model/run configs, the
(optionally INT8-, INT4- or FP8-quantized) parameters on one device, the
What/When/Where verdicts as a static `KernelPlanTable` per serving
phase, and the step programs.  `ServeSession`
(repro_torch.serving.engine) and `ContinuousBatchingEngine`
(repro_torch.serving.scheduler) are thin mutable shells over one core.

The verdicts come from the batched planner (backend="vectorized") on the
sweep engine of the core's own device; `plan_cache_telemetry` reports
how much of that plan build the engine's result cache served.

Two kinds of step, as in the JAX package, which compiles each once per
plan:

  * `step(cache, tokens, pos)` / `prefill_step(...)` — the fixed-batch
    step (one position shared by the batch) under the decode or the
    prefill plan table, what `ServeSession` drives;
  * `batch_step_for(plan)` -> `(cache, tokens, pos, active,
    block_tables) -> (logits, cache)` — the continuous-batching step:
    ragged per-slot positions, an active-slot mask and a paged KV block
    pool (models.model.init_paged_cache).  Variants are memoized per
    plan table in an LRU bounded by `max_plan_variants`, so an adaptive
    engine swapping between plans reuses each variant's program.

On a CUDA core each program is a CUDA graph (`serving.graphs.StepGraph`),
captured once, on its first call, and replayed after: the counterpart of
the JAX package's one compiled executable.  The step's inputs are copied
into the graph's static tensors; the cache is captured by address and
updated in place, so a caller keeps passing the same cache (a different
cache is a new capture).  `decode_executables`, `prefill_executables` and
`batch_decode_executables` count captures: exactly 1 after any
fixed-batch traffic, and one per distinct plan served for the batch
step.  A capture that fails raises; it never falls back to the eager
step.  On a CPU core the steps run eagerly and those counters return
None, as the JAX package's do when its jit-cache probe is missing.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any

import torch

from ..configs.base import ModelConfig, RunConfig
from ..core.llm_workloads import is_projection_label, phase_gemms_of_model
from ..core.planner import plan_workload_by_phase
from ..core.sweep import default_engine, measured_cache_delta
from ..models import decode_step, init_cache
from ..models.layers import route_trace
from ..models.model import with_absorbed
from ..quant import (PRECISIONS, KernelPlanTable,
                     quantize_model_params_lowbit, strip_model_prefix)
from .graphs import StepGraph, leaves


def token_shape(cfg: ModelConfig, batch: int) -> tuple[int, ...]:
    """The shape of one step's tokens: (batch, 1), audio (batch, 1, nb)."""
    return (batch, 1) + ((cfg.audio.n_codebooks,)
                         if cfg.family == "audio" else ())


def sample_token(cfg: ModelConfig, logits, temperature: float,
                 generator: torch.Generator | None = None):
    """Greedy / temperature sampling of the next token from step logits.
    Returns int64 tokens shaped for feeding back into the decode step:
    (b, 1), audio (b, 1, nb), one token per codebook.

    Greedy decoding (temperature <= 0) takes the first maximum, as
    jnp.argmax does.  Temperature sampling draws from `generator`; it
    cannot give the JAX package's draws."""
    last = logits[:, -1]
    if temperature <= 0.0:
        tok = torch.argmax(last, dim=-1)
    else:
        probs = torch.softmax(last.float() / temperature, dim=-1)
        tok = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                generator=generator).reshape(probs.shape[:-1])
    return tok[:, None].long()


def meta_route_records(cfg: ModelConfig, rc: RunConfig, params, plan,
                       batch: int, max_len: int,
                       n_image_tokens: int = 0) -> list[dict]:
    """The `route_trace` records of one decode step of `params` (on
    "meta") under `plan`, over a "meta" cache: shapes only, no compute,
    no kernel launch."""
    cache = init_cache(cfg, rc, batch, max_len, device="meta",
                       n_image_tokens=n_image_tokens)
    tokens = torch.zeros(token_shape(cfg, batch), dtype=torch.long,
                         device="meta")
    with route_trace() as records, torch.inference_mode():
        decode_step(params, cache, tokens, 0, cfg, rc, plan=plan)
    return records


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

    A model with latent attention gets its absorbed decode operands
    (W_UK, W_UV from W_kvb, `models.model.with_absorbed`) once, here.

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
    # bound on cached batch-step variants (one per distinct plan table
    # the adaptive layer has served)
    max_plan_variants: int = 4

    def __post_init__(self):
        if self.max_plan_variants < 1:
            raise ValueError(f"max_plan_variants must be >= 1, "
                             f"got {self.max_plan_variants}")
        if self.quantize and self.precision not in PRECISIONS:
            raise ValueError(f"unknown precision {self.precision!r} "
                             "(expected int8/int4/fp8)")
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("DecodeCore runs on 'cuda' by default and this "
                               "torch has no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        for leaf in leaves(self.params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params live on {leaf.device}, the core "
                                 f"runs on {self.device}")
        self._kernel_plan = None
        self._kernel_plans = None
        self._plan_cache_telemetry = None
        self._plan_lock = threading.Lock()
        self._verdict_table = None
        self._phase_verdict_tables = None
        self._graphs: dict = {}          # fixed-batch StepGraphs
        self._batch_steps: OrderedDict = OrderedDict()
        self._exec_lock = threading.Lock()
        self.plan_evictions = 0
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
        self.params = with_absorbed(self.params, self.cfg)

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

    # --- the steps ---------------------------------------------------------

    @property
    def graphed(self) -> bool:
        """True when the steps run as CUDA graphs (a CUDA core)."""
        return self.device.type == "cuda"

    def _fixed(self, plan, cache, tokens, pos):
        with torch.inference_mode():
            if not self.graphed:
                return decode_step(self.params, cache, tokens, pos, self.cfg,
                                   self.rc, plan=plan)
            key = (plan, _cache_key(cache), tuple(tokens.shape))
            graph = self._graphs.get(key)
            if graph is None:
                cfg, rc, params = self.cfg, self.rc, self.params
                graph = self._graphs[key] = StepGraph(
                    lambda t, p: decode_step(params, cache, t, p, cfg, rc,
                                             plan=plan)[0], keep=cache)
            return graph(tokens, pos), cache

    def step(self, cache, tokens, pos):
        """Fixed-batch decode step (one position shared by the batch: an
        int or a 0-d device tensor), gated by the decode plan; updates
        `cache` in place and returns (logits, cache)."""
        return self._fixed(self.plan_table, cache, tokens, pos)

    def prefill_step(self, cache, tokens, pos):
        """The prefill-phase per-token step: the same decode step gated by
        the *prefill* plan table (one shared program when the phase
        tables are equal)."""
        return self._fixed(self.prefill_plan_table, cache, tokens, pos)

    def batch_step_for(self, plan) -> "BatchStep":
        """The continuous-batching step for one (versioned) plan table:
        (cache, tokens, pos, active, block_tables) -> (logits, cache),
        with pos (b,) int, active (b,) bool and block_tables (b,
        max_blocks) int device tensors — join, evict and ragged lengths
        replay the same program.

        Variants are memoized per plan table (the table's hash and
        equality are its version) in an LRU bounded by
        `max_plan_variants`; a table evicted from the bound is captured
        again if it returns (`plan_evictions` counts the drops)."""
        with self._exec_lock:
            fn = self._batch_steps.get(plan)
            if fn is None:
                fn = self._batch_steps[plan] = BatchStep(self, plan)
            self._batch_steps.move_to_end(plan)
            while len(self._batch_steps) > self.max_plan_variants:
                self._batch_steps.popitem(last=False)
                self.plan_evictions += 1
        return fn

    @property
    def batch_step(self) -> "BatchStep":
        """The continuous-batching step of this core's own decode plan
        table (the non-adaptive path) — see `batch_step_for`."""
        return self.batch_step_for(self.plan_table)

    @property
    def plan_variants(self) -> int:
        """Distinct plan tables with a live batch-step variant."""
        with self._exec_lock:
            return len(self._batch_steps)

    def _captures(self, plan) -> int | None:
        if not self.graphed:
            return None
        return sum(g.captures for (p, *_), g in self._graphs.items()
                   if p == plan)

    @property
    def decode_executables(self) -> int | None:
        """CUDA graphs captured for the fixed-batch decode step (exactly 1
        after any traffic through one cache).  None on a CPU core, where
        the step runs eagerly."""
        return self._captures(self.plan_table)

    @property
    def prefill_executables(self) -> int | None:
        """CUDA graphs captured for the prefill-phase step (the decode
        step's own graph, and count, when the phase tables are equal).
        None on a CPU core."""
        return self._captures(self.prefill_plan_table)

    @property
    def batch_decode_executables(self) -> int | None:
        """CUDA graphs captured across every cached batch-step variant:
        1 for frozen-plan traffic, the number of distinct plan tables
        for adaptive traffic.  None on a CPU core."""
        if not self.graphed:
            return None
        with self._exec_lock:
            steps = list(self._batch_steps.values())
        return sum(s.captures for s in steps)

    def route_report(self, batch: int, max_len: int,
                     n_image_tokens: int = 0) -> dict:
        """label -> {route, use_cim, what, where} as the decode step runs
        them, from one step on "meta" tensors (shapes only, no compute,
        no kernel launch).  The MoE expert labels read the dequant route:
        on the card a bf16 step's INT8 experts run the grouped expert
        kernels there (`models/moe.py`), which compute that route's
        function and are not on the INT8 GEMM's plan."""
        records = meta_route_records(self.cfg, self.rc, _meta(self.params),
                                     self.plan_table, batch, max_len,
                                     n_image_tokens)
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


def _cache_key(cache) -> tuple:
    """A cache's identity: the addresses of its tensors."""
    return tuple(t.data_ptr() for t in leaves(cache))


class BatchStep:
    """The continuous-batching step of one plan table (see
    `DecodeCore.batch_step_for`): one CUDA graph per cache on a CUDA
    core, the eager step on a CPU core."""

    def __init__(self, core: DecodeCore, plan):
        self.core = core
        self.plan = plan
        self.graphs: dict = {}

    @property
    def captures(self) -> int:
        return sum(g.captures for g in self.graphs.values())

    def __call__(self, cache, tokens, pos, active, block_tables):
        core, plan = self.core, self.plan
        with torch.inference_mode():
            if not core.graphed:
                return decode_step(core.params, cache, tokens, pos,
                                   core.cfg, core.rc, plan=plan,
                                   active=active, block_tables=block_tables)
            key = (_cache_key(cache), tuple(tokens.shape),
                   tuple(block_tables.shape))
            graph = self.graphs.get(key)
            if graph is None:
                cfg, rc, params = core.cfg, core.rc, core.params
                graph = self.graphs[key] = StepGraph(
                    lambda t, p, a, bt: decode_step(
                        params, cache, t, p, cfg, rc, plan=plan, active=a,
                        block_tables=bt)[0], keep=cache)
            return graph(tokens, pos, active, block_tables), cache
