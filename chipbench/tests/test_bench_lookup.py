"""A cell, a configuration and a metric are added by adding files and
entries: a copy of the benchmark with a new cell file, configuration
file and metric reader runs the new cell, with the new metric in its
result line, and no file that was there edited."""
import json
import shutil
import subprocess
import sys

from chipbench import spec

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from chipbench import harness, spec
bench = spec.load_benchmark()
entry = spec.workload(bench, "tiny-dense.chat-mini")
ctx = harness.Ctx(bench=bench, workload=entry["name"],
                  cell=spec.load_cell(entry["name"]),
                  model=spec.load_config(bench, entry["config"])["model"],
                  seed=2 ** 31 + 7, seconds=1.5, trace=False, device="cpu",
                  t_start=time.perf_counter())
print(json.dumps(harness.run(ctx)))
"""


def test_new_cell_config_and_metric_are_found(tmp_path):
    from chipbench.tests import tiny
    shutil.copytree(spec.HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in tmp_path.rglob("*") if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cb = tmp_path / "chipbench"
    (cb / "configs" / "tiny-dense.json").write_text(
        json.dumps({"name": "tiny-dense", "model": tiny.DENSE}))
    cell = tiny.engine_cell("qwen2-7b.chat-poisson")
    cell["check"]["limit"] = 0.05
    (cb / "cells" / "tiny-dense.chat-mini.json").write_text(json.dumps(cell))
    (cb / "metrics" / "requests_attempted.py").write_text(
        "def read(run):\n    return float(run['attempted'])\n")
    bench["configs"].append({"name": "tiny-dense", "source": "test",
                             "file": "chipbench/configs/tiny-dense.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny-dense.chat-mini",
                               "config": "tiny-dense",
                               "traffic": "chat-mini", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "requests_attempted",
                                "unit": "requests", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["tiny-dense.chat-mini"]})
    for m in bench["end_to_end"]:
        if m["name"] == "itl_p95_ms":
            m["workloads"].append("tiny-dense.chat-mini")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(tmp_path),
         str(spec.ROOT / "src")], capture_output=True, text=True,
        cwd=tmp_path, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert set(result["metrics"]) == {"setup_s", "itl_p95_ms",
                                      "requests_attempted"}
    assert result["metrics"]["requests_attempted"]["value"] == \
        result["attempted"]
    # every file that was there is as it was (BENCHMARK.json gained
    # entries only)
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, p
    old = json.loads(before[tmp_path / "BENCHMARK.json"])
    for key in ("configs", "workloads"):
        assert bench[key][:len(old[key])] == old[key]
