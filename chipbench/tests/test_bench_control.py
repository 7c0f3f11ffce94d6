"""The control: the reference computed with INT4 weights, the precision
below the configurations' INT8, has to come out not correct where the
program comes out correct.

On the CPU at tiny widths against the tiny cells' limit (0.05, see
test_bench_faults.py); on the card (marker `cuda`) at each cell's own
size and load, one seed and a 20-s window each, against the cell's
limit.  chipbench/calibrate.py reads the same two numbers over many
seeds; PERF.md gives the readings each limit was set from."""
import time

import pytest
import torch

from chipbench import calibrate, harness, spec
from chipbench.tests import tiny

CELLS = ["qwen2-7b.chat-poisson", "qwen2-moe-a2.7b.chat-backlog",
         "qwen2-7b.score-prefill"]


def _ctx(cell, model, seed, seconds, device, workload="x", arch=tiny.ARCH):
    return harness.Ctx(bench=spec.load_benchmark(), workload=workload,
                       cell=cell, model=model, arch=arch, seed=seed,
                       seconds=seconds, trace=False, device=device,
                       t_start=time.perf_counter())


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 4])
def test_control_fails_where_the_program_holds_cpu(seed):
    cell = tiny.engine_cell("qwen2-7b.chat-poisson")
    r = calibrate.reading(_ctx(cell, tiny.DENSE, seed, 2.0, "cpu"))
    assert r["program_gap"] <= 0.05 < r["control_gap"], r


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_holds(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run at their own size")
    bench = spec.load_benchmark()
    entry = spec.workload(bench, workload)
    cell = spec.load_cell(workload)
    config = spec.load_config(bench, entry["config"])
    r = calibrate.reading(_ctx(cell, config["model"], 2 ** 31 + 99, 20.0,
                               "cuda", workload, config["arch"]))
    assert (r["program_compared"] <= cell["check"]["limit"]
            < r["control_compared"]), r
