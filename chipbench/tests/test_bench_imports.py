"""The import guard: nothing the benchmark loads has the top-level name
jax, jaxlib, flax or repro (compared whole: repro_torch is the program,
not the JAX package), and the reference loads nothing of the program."""
import os
import subprocess
import sys

from chipbench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}

RUN = r"""
import sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import chipbench.run, chipbench.calibrate, chipbench.sweep_rate
from chipbench.tests import tiny
tiny.run(tiny.engine_cell("qwen2-7b.chat-poisson"), tiny.MOE, seconds=1.0,
         trace=True, workload="qwen2-moe-a2.7b.chat-backlog")
tiny.run(tiny.prefill_cell(), tiny.DENSE, seconds=1.0, trace=True,
         workload="qwen2-7b.score-prefill")
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
print("flagged:" + " ".join(chipbench.run.forbidden_modules()))
"""

REF = r"""
import sys
sys.path[:0] = [sys.argv[1]]
import chipbench.reference, chipbench.check, chipbench.weights
import chipbench.flops, chipbench.traffic, chipbench.window
print(" ".join(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _top_names(script, *args):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", script, *args],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=str(spec.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()


def test_a_run_loads_no_jax_nor_the_jax_package():
    names, flagged = _top_names(RUN, str(spec.ROOT),
                                str(spec.ROOT / "src"))[-2:]
    top = set(names.split())
    assert "repro_torch" in top and "chipbench" in top
    assert not top & FORBIDDEN
    assert flagged == "flagged:"


def test_the_reference_loads_nothing_of_the_program():
    names = set(_top_names(REF, str(spec.ROOT))[-1].split())
    assert not names & (FORBIDDEN | {"repro_torch"})


def test_the_guard_compares_whole_names(monkeypatch):
    from chipbench import run
    monkeypatch.setitem(sys.modules, "repro_torchx", sys)
    assert "repro" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert run.forbidden_modules() == ["repro"]
