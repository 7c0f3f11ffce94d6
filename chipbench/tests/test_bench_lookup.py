"""A cell, a configuration, a metric and an architecture are added by
adding files and entries: a copy of the benchmark with a new cell file,
configuration file, metric reader or architecture module runs the new
cell, with the new metric in its result line and judged by the new
module, and no file that was there edited."""
import json
import shutil
import subprocess
import sys

from chipbench import spec
from chipbench.tests import tiny

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(1)    # tiny widths: one thread, also beside others
from chipbench import harness, spec
bench = spec.load_benchmark()
entry = spec.workload(bench, sys.argv[3])
config = spec.load_config(bench, entry["config"])
ctx = harness.Ctx(bench=bench, workload=entry["name"],
                  cell=spec.load_cell(entry["name"]), model=config["model"],
                  arch=config["arch"], seed=2 ** 31 + 7, seconds=1.5,
                  trace=False, device="cpu", t_start=time.perf_counter())
print(json.dumps(harness.run(ctx)))
"""

# the qwen2 decoder judged with its logits negated: what the program puts
# first, this reference ranks last
FLIPPED = '''"""qwen2 with the reference's LM head negated."""
from chipbench.archs.qwen2 import *  # noqa: F401,F403
from chipbench.archs import qwen2


def head(params, bits=8):
    return -qwen2.head(params, bits)
'''


def _copy(tmp_path):
    """A copy of the benchmark, and the bytes of every file in it."""
    shutil.copytree(spec.HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}


def _add_cell(tmp_path, bench, config, arch):
    """A configuration `config` of the tiny dense model naming `arch`, and
    its cell `<config>.chat-mini`, reporting `itl_p95_ms`."""
    cb = tmp_path / "chipbench"
    (cb / "configs" / f"{config}.json").write_text(
        json.dumps({"name": config, "arch": arch, "model": tiny.DENSE}))
    cell = tiny.engine_cell("qwen2-7b.chat-poisson")
    cell["check"]["limit"] = 0.05
    name = f"{config}.chat-mini"
    (cb / "cells" / f"{name}.json").write_text(json.dumps(cell))
    bench["configs"].append({"name": config, "source": "test",
                             "file": f"chipbench/configs/{config}.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": name, "config": config,
                               "traffic": "chat-mini", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] == "itl_p95_ms":
            m["workloads"].append(name)
    return name


def _run(tmp_path, bench, workload):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path),
         str(spec.ROOT / "src"), workload], capture_output=True, text=True,
        cwd=tmp_path, timeout=300)


def _result(out):
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _unedited(tmp_path, before, bench):
    """Every file that was there is as it was (BENCHMARK.json gained
    entries only)."""
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    old = json.loads(before[tmp_path / "BENCHMARK.json"])
    for key in ("configs", "workloads"):
        assert bench[key][:len(old[key])] == old[key]


def test_new_cell_config_and_metric_are_found(tmp_path):
    before = _copy(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    name = _add_cell(tmp_path, bench, "tiny-dense", tiny.ARCH)
    (tmp_path / "chipbench" / "metrics" / "requests_attempted.py"
     ).write_text("def read(run):\n    return float(run['attempted'])\n")
    bench["end_to_end"].append({"name": "requests_attempted",
                                "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": [name]})
    result = _result(_run(tmp_path, bench, name))
    assert result["correct"], result["checks"]
    assert set(result["metrics"]) == {"setup_s", "itl_p95_ms",
                                      "requests_attempted"}
    assert result["metrics"]["requests_attempted"]["value"] == \
        result["attempted"]
    _unedited(tmp_path, before, bench)


def test_new_architecture_is_found(tmp_path):
    """A configuration naming a new module of chipbench/archs/ is judged
    by that module's reference: the program runs the qwen2 decoder, so a
    reference with the head negated ranks its tokens last."""
    before = _copy(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    (tmp_path / "chipbench" / "archs" / "qwen2_flipped.py").write_text(
        FLIPPED)
    name = _add_cell(tmp_path, bench, "tiny-flipped", "qwen2_flipped")
    result = _result(_run(tmp_path, bench, name))
    assert not result["correct"]
    gap = result["checks"]["top_token_gap"]
    assert gap["value"] > 10 * gap["limit"], gap
    assert result["checks"]["tokens_compared"]["value"] >= 16
    assert set(result["metrics"]) == {"setup_s", "itl_p95_ms"}
    _unedited(tmp_path, before, bench)


def test_missing_architecture_is_named(tmp_path):
    _copy(tmp_path)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    name = _add_cell(tmp_path, bench, "tiny-lost", "no_such_arch")
    out = _run(tmp_path, bench, name)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "chipbench/archs/no_such_arch.py" in out.stderr, \
        out.stderr[-2000:]
