"""Tiny configurations and cells for running the harness on the CPU
(both of the architecture `ARCH`)."""
from __future__ import annotations

import copy
import time

from chipbench import harness, spec

ARCH = "qwen2"
DENSE = {"name": "tiny-dense", "family": "dense", "n_layers": 2,
         "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
         "vocab": 256, "d_head": 16, "qkv_bias": True,
         "rope_theta": 1000000.0, "rmsnorm_eps": 1e-05,
         "tie_embeddings": False, "param_dtype": "bfloat16",
         "compute_dtype": "bfloat16"}
MOE = dict(DENSE, name="tiny-moe", family="moe", d_ff=32,
           moe={"n_experts": 8, "top_k": 2, "n_shared_experts": 1,
                "expert_d_ff": 32, "shared_d_ff": 64, "every_n_layers": 1,
                "capacity_factor": 1.25, "router_aux_loss": 0.001})


def engine_cell(name: str, slots: int = 4, max_len: int = 64,
                arrival: str = "backlog") -> dict:
    """The benchmark's cell `name` cut to CPU size: its driver, run
    config and check, with few slots and short requests."""
    cell = copy.deepcopy(spec.load_cell(name))
    cell.update(slots=slots, max_len=max_len, block_size=8,
                trace_seconds=0.5, warm_s=0.5)
    t = cell["traffic"]
    t.update(requests=16, prompt=dict(t["prompt"], median=6, min=2, max=12),
             output=dict(t["output"], dist="lognormal", median=8,
                         sigma=0.5, min=2, max=16))
    t["arrival"] = arrival
    if arrival == "poisson":
        t["rate"] = 20.0
    else:
        t["depth"] = slots
    cell["check"] = dict(cell["check"], tokens=48, min_tokens=16)
    return cell


def prefill_cell() -> dict:
    cell = copy.deepcopy(spec.load_cell("qwen2-7b.score-prefill"))
    cell["run_config"] = dict(cell["run_config"], attn_chunk=8)
    cell["traffic"].update(requests=4, prompt={
        "dist": "loguniform", "min": 16, "max": 64, "multiple": 16})
    cell["trace_seconds"] = 0.5
    cell["check"] = dict(cell["check"], forwards=2, min_tokens=16)
    return cell


def run(cell: dict, model: dict, seed: int = 7, seconds: float = 2.0,
        trace: bool = False, workload: str = "qwen2-7b.chat-poisson"):
    ctx = harness.Ctx(bench=spec.load_benchmark(), workload=workload,
                      cell=cell, model=model, arch=ARCH, seed=seed,
                      seconds=seconds,
                      trace=trace, device="cpu", t_start=time.perf_counter())
    return harness.run(ctx)
