"""The paper's experiments in the port against the JAX package, on the CPU.

* `random_search` on the seeds and settings of tests/test_core.py's
  heuristic tests, every field of its result bit for bit;
* `synthetic_dataset`, `square_sweep` and Table VI's `REAL_WORKLOADS`
  GEMM for GEMM;
* each function of `repro_torch.launch.paper` against the function of
  the same name in benchmarks/paper_benches.py, run live here (not read
  from results/bench/, whose derived files were written by an older
  run): rows and derived metrics equal, the wall-time fields
  (`RUNTIME_FIELDS`) excepted.  Figs. 9-13 are scored on each sweep
  backend of the port (on a fresh engine, so the plain version of the
  sweep kernel really runs).  Their tolerance is the one
  tests/test_torch_sweep.py holds the engines to: CiM metrics exactly,
  tensor-core baseline metrics within a relative 1e-6; the derived
  metrics of a figure inherit its rows' tolerance.  (Measured: every
  row and derived value bit-equal.)
* the CLI writes `<name>.csv` and `<name>.derived.json` into `--out`.

No timing is asserted.
"""
import dataclasses
import json
import math

import pytest

from benchmarks import paper_benches as ref_paper
from repro.core import (ANALOG_8T as J_ANALOG_8T, DIGITAL_6T as J_DIGITAL_6T,
                        GEMM as JGEMM, CiMSystemConfig as JCfg)
from repro.core import REAL_WORKLOADS as J_REAL_WORKLOADS
from repro.core import random_search as j_random_search
from repro.core import square_sweep as j_square_sweep
from repro.core import synthetic_dataset as j_synthetic_dataset

from repro_torch.core import (ANALOG_8T, DIGITAL_6T, GEMM, REAL_WORKLOADS,
                              CiMSystemConfig, SweepEngine, random_search,
                              square_sweep, synthetic_dataset)
from repro_torch.launch import paper

BASE_RTOL = 1e-6        # tests/test_torch_sweep.py's baseline tolerance
# the rows' fields that come from the tensor-core baseline
BASELINE_FIELDS = ("baseline_tops_w", "baseline_gflops", "Tcore_fj_mac",
                   "Tcore_gflops")
SWEEPS = [n for n, (_, sweeps) in paper.ARTEFACTS.items() if sweeps]
HOST_ONLY = [n for n, (_, sweeps) in paper.ARTEFACTS.items() if not sweeps]


def _fields(m):
    if m is None:
        return None
    d = dataclasses.asdict(m)
    d["mapping"] = (None if m.mapping is None
                    else dataclasses.asdict(m.mapping)["dram_loops"])
    return d


# test_core.py: test_heuristic_never_beats_priority_much and
# test_heuristic_terminates_and_reports
HEURISTIC_CASES = [((512, 1024, 1024), "D6", 1, 300, 20_000),
                   ((16, 16, 16), "A8", 0, 50, 200)]


@pytest.mark.parametrize("shape,prim,seed,max_valid,max_invalid",
                         HEURISTIC_CASES)
def test_random_search_bit_for_bit(shape, prim, seed, max_valid,
                                   max_invalid):
    prims = {"D6": (DIGITAL_6T, J_DIGITAL_6T), "A8": (ANALOG_8T, J_ANALOG_8T)}
    p, jp = prims[prim]
    got = random_search(GEMM(*shape), CiMSystemConfig(prim=p, cim_level="RF"),
                        seed=seed, max_valid=max_valid,
                        max_consecutive_invalid=max_invalid)
    want = j_random_search(JGEMM(*shape), JCfg(prim=jp, cim_level="RF"),
                           seed=seed, max_valid=max_valid,
                           max_consecutive_invalid=max_invalid)
    assert (got.sampled, got.valid, got.consecutive_invalid_stop) == (
        want.sampled, want.valid, want.consecutive_invalid_stop)
    assert got.best is not None
    assert _fields(got.best) == _fields(want.best)


def _gemms(gs):
    return [(g.M, g.N, g.K, g.label, g.count, g.bits, g.fp) for g in gs]


@pytest.mark.parametrize("kw", [{}, {"n": 24, "seed": 0},
                                {"n": 120, "seed": 1},
                                {"n": 50, "seed": 7, "lo": 64, "hi": 512}])
def test_synthetic_dataset_bit_for_bit(kw):
    assert _gemms(synthetic_dataset(**kw)) == _gemms(j_synthetic_dataset(**kw))


def test_square_sweep_and_real_workloads_equal_reference():
    assert _gemms(square_sweep()) == _gemms(j_square_sweep())
    assert _gemms(square_sweep(64, 8192)) == _gemms(j_square_sweep(64, 8192))
    assert list(REAL_WORKLOADS) == list(J_REAL_WORKLOADS)
    for name, gs in REAL_WORKLOADS.items():
        assert _gemms(gs) == _gemms(J_REAL_WORKLOADS[name])


def _close(got, want, rel):
    """Equal, or (floats) within `rel` of `want`, recursing into dicts."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _close(got[k], want[k], rel)
    elif isinstance(want, float) and not math.isnan(want):
        assert got == pytest.approx(want, rel=rel, abs=0.0)
    else:
        assert got == want


def _equal_rows(rows, want, baseline_rel):
    assert len(rows) == len(want)
    for got, ref in zip(rows, want):
        assert list(got) == list(ref)
        for k in ref:
            _close(got[k], ref[k], baseline_rel if k in BASELINE_FIELDS
                   else 0.0)


def _without_runtime(derived):
    return {k: v for k, v in derived.items()
            if k not in paper.RUNTIME_FIELDS}


@pytest.fixture(scope="module")
def reference():
    """Every reference artefact, run once for the module."""
    return {name: getattr(ref_paper, name)() for name in paper.ARTEFACTS}


@pytest.mark.parametrize("name", HOST_ONLY)
def test_host_artefacts_bit_for_bit(name, reference):
    """Fig. 2, Fig. 7 + Table II (the scalar mapper against the random
    search) and Table VI: rows and derived metrics bit for bit, Fig. 7's
    wall times aside."""
    rows, derived = paper.ARTEFACTS[name][0]()
    want_rows, want_derived = reference[name]
    assert rows == want_rows
    assert _without_runtime(derived) == _without_runtime(want_derived)
    assert set(derived) == set(want_derived)


@pytest.mark.parametrize("backend", ["vectorized", "pallas"])
@pytest.mark.parametrize("name", SWEEPS)
def test_sweep_artefacts_equal_reference(name, backend, reference):
    """Figs. 9-13 on each backend, on a fresh CPU engine: CiM metrics
    exactly, baseline metrics within BASE_RTOL, and the derived metrics
    within the tolerance of the rows they come from."""
    engine = SweepEngine(device="cpu")
    rows, derived = paper.ARTEFACTS[name][0](backend=backend, device="cpu",
                                             engine=engine)
    want_rows, want_derived = reference[name]
    _equal_rows(rows, want_rows, BASE_RTOL)
    baseline = name in ("fig11_12_memory_levels", "fig13_square_gemms")
    _close(derived, want_derived, BASE_RTOL if baseline else 0.0)
    info = engine.cache_info()["backends"][backend]
    assert info["misses"] > 0


def test_reproduction_checks_of_the_docs():
    """docs/reproducing-paper-figures.md's two checks of Fig. 7, on the
    port's derived metrics."""
    _, d = paper.fig7_table2_mapping_vs_heuristic()
    assert d["runtime_ratio"] > 1
    assert 0.8 < d["tops_w_gain_geomean"] < 1.3


def test_cli_writes_csv_and_derived(tmp_path, capsys, reference):
    """`python -m repro_torch.launch.paper` writes each artefact's CSV
    and derived JSON into --out, in the benchmark runner's formats."""
    paper.main(["--device", "cpu", "--backend", "pallas", "--out",
                str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,seconds,derived"
    assert [line.split(",")[0] for line in out[1:]] == list(paper.ARTEFACTS)
    for name in paper.ARTEFACTS:
        want_rows, want_derived = reference[name]
        with open(tmp_path / f"{name}.derived.json") as f:
            got = json.load(f)
        want = json.loads(json.dumps(want_derived))
        _close(_without_runtime(got), _without_runtime(want), BASE_RTOL)
        lines = (tmp_path / f"{name}.csv").read_text().splitlines()
        assert lines[0].split(",") == list(want_rows[0])
        assert len(lines) == 1 + len(want_rows)
    with pytest.raises(SystemExit):
        paper.main(["--device", "cpu", "--backend", "xla"])


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        paper.fig13_square_gemms(backend="xla", device="cpu")
