"""The result line: the keys the driver reads, in order, `checks` last;
and no result at all without a card."""
import json
import os
import subprocess
import sys

import pytest

from chipbench import spec
from chipbench.tests import tiny


@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_line_shape(trace):
    cell = tiny.engine_cell("qwen2-7b.chat-poisson", arrival="poisson")
    r = tiny.run(cell, tiny.DENSE, seconds=1.5, trace=trace)
    line = json.loads(json.dumps(r))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert isinstance(line["correct"], bool)
    assert line["attempted"] > 0 and line["failed"] == 0
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = line["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    bench = spec.load_benchmark()
    names = {m["name"] for m in spec.metrics_of(
        bench, "qwen2-7b.chat-poisson", trace)}
    assert set(line["metrics"]) <= names
    if trace:
        assert {"busy_s", "window_s"} <= set(dev)
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == names
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_no_card_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "chipbench/run.py", "--workload",
           "qwen2-7b.chat-poisson", "--seed", "1", "--seconds", "1",
           "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=str(spec.ROOT), env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    import shutil
    shutil.copytree(spec.HERE, tmp_path / "chipbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(cmd, capture_output=True, text=True,
                         cwd=str(tmp_path), env=env, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
