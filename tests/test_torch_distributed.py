"""The port's distributed layer on torch.distributed, on the CPU (gloo).

* the streaming chunk enumerator and its accounting (`padded_rows`,
  `distributed`), counterparts of tests/test_distributed_sweep.py's fast
  tier;
* `launch.distributed`'s init / env plumbing, the row mesh, the shard
  balance, `host_local_to_global` and `gather_rows` in a one-rank gloo
  group (a FileStore under tmp_path, destroyed in the fixture);
* a one-rank row mesh bitwise equal to the unsharded engine in both
  order modes and both backends (tests/test_sweep.py:172-196);
* THE gate, which the JAX package keeps @slow and the port runs in
  tier-1: 2 OS processes in a gloo group plan the full 1338-row golden
  grid through `distributed_engine(chunk_rows=512)` on both backends,
  and both reproduce tests/golden/planner_verdicts.csv bitwise;
* `compressed_psum` over 4 gloo ranks against the JAX package's
  `vmap(..., axis_name="i")` on the same seeded numpy gradients, 20
  steps, bitwise (reduced means and residuals), two collectives per
  leaf, and the JAX test's convergence bound (< 0.02);
* `make_production_mesh` under a fake group of 256 and 512 ranks.

Worlds above 1 run as subprocesses of this file (`python
tests/test_torch_distributed.py <mode> ...`) on free localhost ports,
each waited on with a timeout and killed in `finally`.
"""
import csv
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as tdist

from repro_torch.core import GEMM, standard_configs
from repro_torch.core.sweep import SweepEngine, _iter_chunks, _pad_len
from repro_torch.launch import distributed as dist
from repro_torch.launch.mesh import abstract_mesh, row_mesh, small_mesh
from repro_torch.optim.grad_compress import (_quant, compressed_psum,
                                             init_error_state)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
GOLDEN = os.path.join(HERE, "golden", "planner_verdicts.csv")
CONFIGS = standard_configs()
GEMMS = [GEMM(512, 1024, 1024), GEMM(1, 4096, 4096), GEMM(17, 100, 300)]
SOME = ("Digital-6T@RF", "Digital-6T@SMEM-B", "Analog-8T@SMEM-A")
N_GRID = 1338
GATE_CHUNK_ROWS = 512          # the 1338-GEMM grid => >= 2 chunks per kind
WORKER_TIMEOUT = 120           # seconds a rank may take (the gate: < 60)
# compressed_psum: ranks, steps, and the leaves of its gradient tree
PSUM_RANKS, PSUM_STEPS = 4, 20
PSUM_LEAVES = {"g": ((64,), "float32"), "w": ((8, 16), "float32"),
               "b": ((3, 5), "bfloat16")}


@pytest.fixture
def gloo1(tmp_path):
    """A one-rank gloo group for the test, destroyed after it."""
    store = tdist.FileStore(str(tmp_path / "store"), 1)
    tdist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        yield
    finally:
        tdist.destroy_process_group()


def _metric_tuple(m):
    return (m.energy_pj, m.time_ns, m.compute_ns, m.dram_ns, m.smem_ns,
            m.utilization, m.dram_bytes, m.smem_bytes, m.mapping)


# --- streaming chunk enumerator (single process) ---------------------------


def test_chunked_engine_bitwise_parity():
    """chunk_rows=7 splits candidate-mapping groups mid-group and leaves
    ragged tails; every bit stays, and the unsharded engine pads
    nothing."""
    eu = SweepEngine(mesh=None, device="cpu")
    ec = SweepEngine(mesh=None, chunk_rows=7, device="cpu")
    pairs = [(g, CONFIGS[n]) for g in GEMMS for n in SOME]
    for om in ("exact", "greedy"):
        for a, b in zip(eu.cim_metrics(pairs, om), ec.cim_metrics(pairs, om)):
            assert _metric_tuple(a) == _metric_tuple(b)
    for a, b in zip(eu.baseline_metrics(GEMMS[:2]),
                    ec.baseline_metrics(GEMMS[:2])):
        assert _metric_tuple(a) == _metric_tuple(b)
    info = ec.cache_info()
    assert info["chunks"]["chunk_rows"] == 7
    assert info["chunks"]["evaluated"] >= 2
    assert info["chunks"]["rows"] > 0
    assert info["chunks"]["padded_rows"] == 0     # no mesh, no padding
    assert info["distributed"] is None
    assert ec.n_shards == 1 and ec.mesh is None


def test_iter_chunks_segments_cover_groups_exactly():
    groups = [("a", {"x": np.arange(5.0)}),
              ("b", {"x": np.arange(100.0, 103.0)}),
              ("c", {"x": np.arange(200.0, 212.0)})]
    seen: dict = {}
    for batch, segs in _iter_chunks(iter(groups), chunk_rows=4):
        n = len(batch["x"])
        assert n <= 4
        for gid, off, lo, hi in segs:
            assert 0 <= lo < hi <= n
            seen.setdefault(gid, []).extend(
                (off + j, batch["x"][lo + j]) for j in range(hi - lo))
    for gid, cols in groups:
        idx, vals = zip(*seen[gid])
        assert list(idx) == list(range(len(cols["x"])))
        assert np.array_equal(np.asarray(vals), cols["x"])
    tiles = list(_iter_chunks(iter(groups), chunk_rows=None))
    assert len(tiles) == 1 and len(tiles[0][0]["x"]) == 20


def test_chunk_rows_validation_and_cache_clear_resets_accounting():
    with pytest.raises(ValueError, match="chunk_rows"):
        SweepEngine(mesh=None, chunk_rows=0, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        SweepEngine(mesh="everywhere", device="cpu").n_shards
    eng = SweepEngine(mesh=None, chunk_rows=8, device="cpu")
    eng.cim_metrics([(GEMMS[0], CONFIGS["Digital-6T@RF"])])
    assert eng.cache_info()["chunks"]["evaluated"] >= 1
    eng.cache_clear()
    c = eng.cache_info()["chunks"]
    assert c["evaluated"] == c["rows"] == c["padded_rows"] == 0
    assert c["chunk_rows"] == 8


def test_pad_len_aligns_to_shards():
    assert [_pad_len(n, 1) for n in (1, 7, 8)] == [1, 7, 8]
    assert [_pad_len(n, 2) for n in (1, 7, 8)] == [2, 8, 8]
    assert [_pad_len(n, 3) for n in (1, 7, 9)] == [3, 9, 9]


def test_auto_mesh_without_a_group_is_unsharded():
    assert not dist.is_initialized()
    eng = SweepEngine(device="cpu")
    assert eng.mesh is None and eng.n_shards == 1
    assert dist.distributed_engine(chunk_rows=64, device="cpu").mesh is None


# --- launch.distributed plumbing -------------------------------------------


def test_initialize_is_noop_when_unconfigured(monkeypatch):
    for var in (dist.ENV_COORDINATOR, dist.ENV_NUM_PROCESSES,
                dist.ENV_PROCESS_ID):
        monkeypatch.delenv(var, raising=False)
    assert dist.initialize() is False
    assert dist.is_initialized() is False
    assert dist.distributed_info() == {"processes": 1, "process_index": 0,
                                       "global_devices": 1,
                                       "local_devices": 1}


def test_initialize_rejects_partial_configuration(monkeypatch):
    monkeypatch.setenv(dist.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.delenv(dist.ENV_NUM_PROCESSES, raising=False)
    monkeypatch.delenv(dist.ENV_PROCESS_ID, raising=False)
    with pytest.raises(ValueError, match="num_processes/process_id"):
        dist.initialize()
    assert not dist.is_initialized()


def test_initialize_cuda_without_a_card_raises(monkeypatch):
    """The group's device defaults to the card; without one it raises
    rather than fall back to gloo on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this torch has a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dist.initialize("127.0.0.1:1", 1, 0)
    assert not dist.is_initialized()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_world_one_from_env_is_idempotent(monkeypatch):
    monkeypatch.setenv(dist.ENV_COORDINATOR, f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv(dist.ENV_NUM_PROCESSES, "1")
    monkeypatch.setenv(dist.ENV_PROCESS_ID, "0")
    try:
        assert dist.initialize(device="cpu") is False     # world of 1
        assert dist.is_initialized() and tdist.get_backend() == "gloo"
        assert dist.initialize(device="cpu") is False     # no-op again
        assert dist.rank_device() == torch.device("cpu")
        assert dist.distributed_info()["processes"] == 1
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def test_multihost_detection_and_shard_balance(gloo1):
    mesh = row_mesh([0])
    assert dist.is_multihost(None) is False
    assert dist.is_multihost(mesh) is False       # this rank only
    assert dist.shard_balance(8, mesh) == {"0": 8}
    assert dist.shard_bounds(8, mesh) == (0, 8)
    two = _TwoRankMesh()
    assert dist.is_multihost(two) is True
    assert dist.shard_balance(8, two) == {"0": 4, "1": 4}
    assert dist.shard_bounds(8, two) == (0, 4)    # rank 0's half
    with pytest.raises(ValueError, match="not aligned"):
        dist.shard_balance(7, two)
    with pytest.raises(ValueError, match="not aligned"):
        dist.shard_bounds(7, two)
    info = dist.distributed_info()
    assert info["processes"] == 1
    assert info["global_devices"] >= info["local_devices"] >= 1


class _TwoRankMesh:
    """A stand-in row mesh of ranks 0 and 1 over the one-rank group (the
    balance and bounds read only its ranks, size and group)."""
    mesh = torch.tensor([0, 1])

    def size(self):
        return 2

    def get_group(self):
        return tdist.group.WORLD


def test_global_row_mesh_spans_all_ranks(gloo1):
    mesh = dist.global_row_mesh()
    assert mesh.size() == tdist.get_world_size() == 1
    assert mesh.mesh_dim_names == ("rows",)
    assert mesh.device_type == "cpu"              # gloo: the CPU
    assert small_mesh(1, 1).mesh_dim_names == ("data", "model")
    eng = dist.distributed_engine(chunk_rows=64)
    assert eng.n_shards == 1 and eng.device == torch.device("cpu")
    assert eng.mesh.mesh_dim_names == ("rows",)


def test_global_row_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialize"):
        dist.global_row_mesh()


def test_host_local_to_global_round_trip(gloo1):
    from torch.distributed.tensor import Shard
    mesh = row_mesh()
    batch = {"a": np.arange(8, dtype=np.float32),
             "b": np.arange(8, 16, dtype=np.float32)}
    gb = dist.host_local_to_global(batch, mesh)
    for k, v in batch.items():
        assert np.array_equal(gb[k].full_tensor().numpy(), v)
        assert gb[k].placements == (Shard(0),)
        assert gb[k].device_mesh.size() == 1
    with pytest.raises(ValueError, match="axis"):
        dist.host_local_to_global(batch, mesh, axis="model")


def test_gather_rows_one_rank(gloo1):
    out = {"x": torch.arange(5.0), "y": torch.arange(5.0, 10.0)}
    got = dist.gather_rows(out, row_mesh())
    assert list(got) == ["x", "y"]
    assert np.array_equal(got["x"], np.arange(5.0, dtype=np.float32))
    assert np.array_equal(got["y"], np.arange(5.0, 10.0, dtype=np.float32))


@pytest.mark.parametrize("chunk_rows", [None, 7])
@pytest.mark.parametrize("backend", ["vectorized", "pallas"])
def test_sharded_engine_bitwise_parity_1rank_mesh(gloo1, backend,
                                                  chunk_rows):
    """An explicit one-rank row mesh runs the sharded path (split,
    gather, strip) and must equal the unsharded engine bit for bit, CiM
    rows in both order modes and the baseline rows."""
    es = SweepEngine(mesh=row_mesh(), chunk_rows=chunk_rows, device="cpu")
    eu = SweepEngine(mesh=None, device="cpu")
    assert es.n_shards == 1
    pairs = [(g, CONFIGS[n]) for g in GEMMS[:2] for n in SOME]
    for om in ("exact", "greedy"):
        for a, b in zip(es.cim_metrics(pairs, om, backend),
                        eu.cim_metrics(pairs, om, backend)):
            assert _metric_tuple(a) == _metric_tuple(b)
    for a, b in zip(es.baseline_metrics(GEMMS), eu.baseline_metrics(GEMMS)):
        assert _metric_tuple(a) == _metric_tuple(b)
    info = es.cache_info()
    assert info["chunks"]["padded_rows"] == 0     # one shard: no padding
    assert info["chunks"]["rows"] == eu.cache_info()["chunks"]["rows"]
    assert info["distributed"] is None            # the mesh is this rank


def test_serve_cli_joins_the_group_and_reports_the_topology(
        monkeypatch, capsys):
    """The serve CLI calls initialize() (here from REPRO_* at a world of 1
    under gloo, so no block); in a group of more than one process its
    fixed-batch report carries distributed_info() as "distributed"."""
    from repro_torch.launch import serve
    argv = ["--arch", "qwen2-7b", "--smoke", "--batch", "2", "--prompt-len",
            "4", "--new-tokens", "2", "--device", "cpu"]
    monkeypatch.setenv(dist.ENV_COORDINATOR, f"127.0.0.1:{_free_port()}")
    monkeypatch.setenv(dist.ENV_NUM_PROCESSES, "1")
    monkeypatch.setenv(dist.ENV_PROCESS_ID, "0")
    try:
        serve.main(argv)
        assert dist.is_initialized() and tdist.get_backend() == "gloo"
        assert "distributed" not in json.loads(capsys.readouterr().out)
        two = {"processes": 2, "process_index": 1, "global_devices": 2,
               "local_devices": 1}
        monkeypatch.setattr(dist, "distributed_info", lambda: dict(two))
        serve.main(argv)
        assert json.loads(capsys.readouterr().out)["distributed"] == two
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()


def test_serve_cli_two_ranks_plan_on_their_own(tmp_path):
    """2 gloo ranks each run the serve CLI's adaptive traffic mode on their
    own traffic (other seeds, other request counts) with a background
    re-plan after every lookup.  Planning is per rank: the shared default
    engine is unsharded, so no rank issues a collective to plan (ranks
    that plan different buckets would otherwise pair mismatched
    all-gathers), and each rank's report is its own."""
    reports = _spawn("serve", 2, tmp_path)
    for rank, got in enumerate(reports):
        assert got["gathers"] == 0
        assert got["engine_mesh"] is None
        assert got["engine_distributed"] is None
        assert got["info"] == {"processes": 2, "process_index": rank,
                               "global_devices": 2, "local_devices": 1}
        rep = got["report"]
        assert rep["requests"] == 3 + 2 * rank
        service = rep["traffic"]["adaptive"]["service"]
        assert service["lookups"] > 0
        # the background re-plans ran: more builds than buckets built
        built = [b for b in service["buckets"].values() if b["builds"]]
        assert sum(b["builds"] for b in built) > len(built)


# --- compressed_psum ---------------------------------------------------------


def test_quant_bounded_error():
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        256).astype(np.float32) * 0.01)
    q, scale = _quant(g)
    assert q.dtype == torch.int8
    back = q.to(torch.float32) * scale
    assert float((back - g).abs().max()) <= float(scale) * 0.51


def test_compressed_psum_one_rank_two_collectives(gloo1, monkeypatch):
    """World 1: exactly two all-reduces per leaf (the JAX package's dead
    first psum is not issued), the residual updated in place, and the
    values equal to the JAX package's function over a one-worker axis."""
    import jax
    import jax.numpy as jnp
    from repro.optim.grad_compress import compressed_psum as ref_psum
    calls = []
    real = tdist.all_reduce

    def counting(t, *a, **kw):
        calls.append((t.dtype, tuple(t.shape)))
        return real(t, *a, **kw)
    monkeypatch.setattr(tdist, "all_reduce", counting)
    grads, _ = _psum_inputs(1, 1)
    grads = {k: v[0, 0] for k, v in grads.items()}
    errors = init_error_state({k: torch.from_numpy(v) for k, v in
                               grads.items()})
    ids = {k: id(v) for k, v in errors.items()}
    red, new_e = compressed_psum(
        {k: _torch_leaf(v, k) for k, v in grads.items()}, errors)
    assert len(calls) == 2 * len(grads)
    assert all(dt in (torch.float32, torch.int32) for dt, _ in calls)
    assert new_e is errors and {k: id(v) for k, v in new_e.items()} == ids

    def body(g, e):
        return ref_psum(g, e, "i")
    jg = {k: jnp.asarray(_jax_leaf(v, k))[None] for k, v in grads.items()}
    je = {k: jnp.zeros((1,) + v.shape, jnp.float32)
          for k, v in grads.items()}
    want_r, want_e = jax.vmap(body, axis_name="i")(jg, je)
    for k in grads:
        assert np.array_equal(red[k].numpy(), np.asarray(want_r[k][0]))
        assert np.array_equal(new_e[k].numpy(), np.asarray(want_e[k][0]))


def _psum_inputs(steps: int, ranks: int, seed: int = 0):
    """Seeded numpy gradients: (varying, constant) dicts of leaf ->
    (steps, ranks, *shape) f32 arrays; the bf16 leaf's values are
    rounded to bf16 (the same values reach both packages)."""
    rng = np.random.default_rng(seed)
    varying, constant = {}, {}
    for name, (shape, dtype) in PSUM_LEAVES.items():
        v = rng.standard_normal((steps, ranks) + shape).astype(np.float32)
        c = rng.standard_normal((ranks,) + shape).astype(np.float32) * 0.1
        if dtype == "bfloat16":
            v = torch.from_numpy(v).bfloat16().float().numpy()
            c = torch.from_numpy(c).bfloat16().float().numpy()
        varying[name] = v * 0.1
        constant[name] = np.broadcast_to(c, (steps,) + c.shape).copy()
    return varying, constant


def _torch_leaf(a, name):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.bfloat16() if PSUM_LEAVES[name][1] == "bfloat16" else t


def _jax_leaf(a, name):
    import jax.numpy as jnp
    return (jnp.asarray(a, jnp.bfloat16)
            if PSUM_LEAVES[name][1] == "bfloat16" else jnp.asarray(a))


def _ref_psum_run(grads: dict):
    """The JAX package's compressed_psum under vmap over the ranks, each
    rank carrying its own residual: (reduced, errors) per step as dicts
    of (steps, ranks, *shape) arrays."""
    import jax
    import jax.numpy as jnp
    from repro.optim.grad_compress import compressed_psum as ref_psum

    def body(g, e):
        return ref_psum(g, e, "i")
    step = jax.vmap(body, axis_name="i")
    steps = next(iter(grads.values())).shape[0]
    errors = {k: jnp.zeros(v.shape[1:], jnp.float32)
              for k, v in grads.items()}
    reds, errs = [], []
    for t in range(steps):
        red, errors = step({k: _jax_leaf(v[t], k) for k, v in grads.items()},
                           errors)
        reds.append({k: np.asarray(v) for k, v in red.items()})
        errs.append({k: np.asarray(v) for k, v in errors.items()})
    return ({k: np.stack([r[k] for r in reds]) for k in grads},
            {k: np.stack([e[k] for e in errs]) for k in grads})


def _spawn(mode: str, nproc: int, tmp_path, extra_env=None) -> list[dict]:
    """Run `nproc` ranks of this file's worker `mode` in a gloo group on a
    free localhost port; return each rank's JSON payload."""
    out_base = str(tmp_path / f"{mode}.json")
    env = dict(os.environ)
    env.update({"PYTHONPATH": os.path.join(REPO, "src"),
                dist.ENV_COORDINATOR: f"127.0.0.1:{_free_port()}",
                dist.ENV_NUM_PROCESSES: str(nproc),
                "WORKER_OUT": out_base, **(extra_env or {})})
    procs = []
    try:
        for i in range(nproc):
            penv = dict(env, **{dist.ENV_PROCESS_ID: str(i)})
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), mode], env=penv,
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        outs = [p.communicate(timeout=WORKER_TIMEOUT) for p in procs]
        for p, (so, se) in zip(procs, outs):
            assert p.returncode == 0, f"worker failed:\n{se[-3000:]}"
            assert "WORKER-OK" in so
    finally:
        # a hung rank (a peer that died mid-collective) must not outlive
        # the test holding the port
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    payloads = []
    for i in range(nproc):
        with open(f"{out_base}.{i}") as f:
            payloads.append(json.load(f))
    return payloads


def _as_array(hexstr: str, shape) -> np.ndarray:
    return np.frombuffer(bytes.fromhex(hexstr), np.float32).reshape(shape)


def test_compressed_psum_four_ranks_matches_reference(tmp_path):
    """4 gloo ranks x 20 steps against vmap(axis_name="i"): every rank's
    reduced mean and residual bitwise equal to the reference's, two
    collectives per leaf per step, and the reference test's convergence
    bound on constant gradients (< 0.02)."""
    payloads = _spawn("psum", PSUM_RANKS, tmp_path)
    varying, constant = _psum_inputs(PSUM_STEPS, PSUM_RANKS)
    for label, grads in (("varying", varying), ("constant", constant)):
        want_r, want_e = _ref_psum_run(grads)
        for rank, pay in enumerate(payloads):
            assert pay["collectives"] == 2 * len(PSUM_LEAVES) * PSUM_STEPS * 2
            got = pay[label]
            for k, (shape, _) in PSUM_LEAVES.items():
                r = _as_array(got["reduced"][k], (PSUM_STEPS,) + shape)
                e = _as_array(got["errors"][k], (PSUM_STEPS,) + shape)
                assert np.array_equal(r, want_r[k][:, rank]), (label, k)
                assert np.array_equal(e, want_e[k][:, rank]), (label, k)
    # error feedback: the mean of the compressed reductions tracks the
    # true mean (tests/test_substrate.py:156-181's bound)
    r = _as_array(payloads[0]["constant"]["reduced"]["g"],
                  (PSUM_STEPS, 64))
    true = constant["g"][0].mean(axis=0)
    assert float(np.abs(r.mean(axis=0) - true).max()) < 0.02


# --- the multi-process acceptance gate -------------------------------------


def _golden_grid():
    """tests/test_golden_verdicts.py's grid, in the port's types."""
    from repro_torch.configs import ARCHS, SHAPES
    from repro_torch.core import gemms_of_model, phase_gemms_of_model
    from repro_torch.core.campaign import parse_precision
    for arch, mc in ARCHS.items():
        workloads = [(s, gemms_of_model(mc, SHAPES[s]))
                     for s in ("train_4k", "decode_32k")]
        phases = phase_gemms_of_model(mc, 2048, 8)
        workloads += [(f"phase-{ph}", gs) for ph, gs in phases.items()]
        for sname, gemms in workloads:
            for g in gemms:
                for tok in ("int8", "int4", "fp8"):
                    bits, fp, _ = parse_precision(tok)
                    yield (arch, sname, tok,
                           g if (g.bits == bits and g.fp == fp)
                           else g.scaled(bits=bits, fp=fp))


def _verdict_rows(plan) -> list[dict]:
    entries = list(_golden_grid())
    decisions = plan([g for *_, g in entries])
    return [{"arch": arch, "shape": sname, "precision": prec,
             "label": g.label, "M": str(g.M), "N": str(g.N), "K": str(g.K),
             "best_energy": d.best_energy,
             "best_throughput": d.best_throughput,
             "use_cim": str(int(d.use_cim)), "where": d.where}
            for (arch, sname, prec, g), d in zip(entries, decisions)]


def test_distributed_engine_matches_golden_fingerprint(tmp_path):
    """2 OS processes x a gloo group x the global row mesh x streaming
    chunks reproduce tests/golden/planner_verdicts.csv bitwise on every
    rank, on both backends."""
    nproc = 2
    payloads = _spawn("sweep", nproc, tmp_path,
                      {"WORKER_CHUNK_ROWS": str(GATE_CHUNK_ROWS)})
    with open(GOLDEN) as f:
        golden = list(csv.DictReader(f))
    for pay in payloads:
        assert pay["processes"] == nproc
        assert pay["global_devices"] >= nproc     # the mesh spans both
        assert pay["local_devices"] < pay["global_devices"]
        assert pay["n_shards"] == nproc
        for backend in ("vectorized", "pallas"):
            run = pay[backend]
            ch = run["chunks"]
            assert ch["evaluated"] >= 2 and ch["rows"] > GATE_CHUNK_ROWS
            d = run["distributed"]
            assert d is not None and d["processes"] == nproc
            assert d["mesh_devices"] == nproc
            assert set(d["shard_balance"]) == {str(j) for j in range(nproc)}
            assert len(set(d["shard_balance"].values())) == 1   # even
            assert (sum(d["shard_balance"].values())
                    == ch["rows"] + ch["padded_rows"])
            assert len(run["rows"]) == len(golden) == N_GRID
            for want, have in zip(golden, run["rows"]):
                assert want == have, (backend, want, have)
    for backend in ("vectorized", "pallas"):      # SPMD: identical plans
        assert payloads[0][backend]["rows"] == payloads[1][backend]["rows"]
        assert (payloads[0][backend]["distributed"]["shard_balance"]
                == payloads[1][backend]["distributed"]["shard_balance"])
    assert payloads[0]["seconds"] < 60 and payloads[1]["seconds"] < 60


def test_make_production_mesh_fake_group(tmp_path):
    """(16, 16) under a fake group of 256 ranks and (2, 16, 16) under 512,
    in a subprocess (a fake default group would outlive the test)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               WORKER_OUT=str(tmp_path / "mesh.json"))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "mesh"], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=WORKER_TIMEOUT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp_path / "mesh.json.0") as f:
        got = json.load(f)
    assert got["single"] == {"shape": [16, 16], "axes": ["data", "model"],
                             "size": 256, "device_type": "cpu"}
    assert got["multi"] == {"shape": [2, 16, 16],
                            "axes": ["pod", "data", "model"], "size": 512,
                            "device_type": "cpu"}
    assert got["single_pod_from"] == {"shape": [16, 16],
                                      "axes": ["data", "model"],
                                      "size": 256, "device_type": "cpu"}
    assert got["single_pod_ranks"] == list(range(256))
    assert got["abstract"] == {"data": 16, "model": 16}


# --- worker modes (run as `python tests/test_torch_distributed.py MODE`) ----


def _dump(payload: dict, rank: int) -> None:
    with open(f"{os.environ['WORKER_OUT']}.{rank}", "w") as f:
        json.dump(payload, f)
    print("WORKER-OK", flush=True)


def _worker_sweep() -> None:
    import time
    t0 = time.perf_counter()
    multi = dist.initialize(device="cpu")
    assert multi and tdist.get_world_size() > 1
    from repro_torch.core.sweep import plan_workload_batched
    chunk_rows = int(os.environ["WORKER_CHUNK_ROWS"])
    payload = dict(dist.distributed_info())
    for backend in ("vectorized", "pallas"):
        engine = dist.distributed_engine(chunk_rows=chunk_rows)
        payload["n_shards"] = engine.n_shards
        rows = _verdict_rows(lambda gemms: plan_workload_batched(
            gemms, engine=engine, backend=backend, device="cpu"))
        info = engine.cache_info()
        payload[backend] = {"rows": rows, "chunks": info["chunks"],
                            "distributed": info["distributed"]}
    payload["seconds"] = time.perf_counter() - t0
    rank = tdist.get_rank()
    tdist.destroy_process_group()
    _dump(payload, rank)


def _worker_serve() -> None:
    import contextlib
    import io
    from repro_torch.core.sweep import default_engine
    from repro_torch.launch import serve
    calls = [0]

    def counting(real):
        def call(*a, **kw):
            calls[0] += 1
            return real(*a, **kw)
        return call
    for name in ("all_gather_single", "all_gather_into_tensor"):
        if hasattr(tdist, name):       # gather_rows takes the first
            setattr(tdist, name, counting(getattr(tdist, name)))
    rank = int(os.environ[dist.ENV_PROCESS_ID])
    argv = ["--arch", "qwen2-7b", "--smoke", "--prompt-len", "6",
            "--new-tokens", "4", "--requests", str(3 + 2 * rank),
            "--slots", "2", "--arrival-rate", "0", "--seed", str(rank),
            "--adaptive", "--refresh-every", "1", "--device", "cpu"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve.main(argv)
    engine = default_engine("cpu")
    payload = {"report": json.loads(buf.getvalue()), "gathers": calls[0],
               "info": dist.distributed_info(),
               "engine_mesh": None if engine.mesh is None else "mesh",
               "engine_distributed": engine.cache_info()["distributed"]}
    tdist.destroy_process_group()
    _dump(payload, rank)


def _worker_psum() -> None:
    dist.initialize(device="cpu")
    rank, world = tdist.get_rank(), tdist.get_world_size()
    calls = [0]
    real = tdist.all_reduce

    def counting(*a, **kw):
        calls[0] += 1
        return real(*a, **kw)
    tdist.all_reduce = counting
    varying, constant = _psum_inputs(PSUM_STEPS, world)
    payload = {}
    for label, grads in (("varying", varying), ("constant", constant)):
        errors = init_error_state({k: torch.zeros(v.shape[2:]) for k, v in
                                   grads.items()})
        reds, errs = [], []
        for t in range(PSUM_STEPS):
            red, errors = compressed_psum(
                {k: _torch_leaf(v[t, rank], k) for k, v in grads.items()},
                errors)
            reds.append({k: v.numpy().copy() for k, v in red.items()})
            errs.append({k: v.numpy().copy() for k, v in errors.items()})
        payload[label] = {
            "reduced": {k: np.stack([r[k] for r in reds]).tobytes().hex()
                        for k in grads},
            "errors": {k: np.stack([e[k] for e in errs]).tobytes().hex()
                       for k in grads}}
    payload["collectives"] = calls[0]
    tdist.destroy_process_group()
    _dump(payload, rank)


def _worker_mesh() -> None:
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch.mesh import (make_production_mesh, mesh_ranks,
                                         single_pod_mesh_from)

    def desc(m):
        return {"shape": list(m.mesh.shape), "axes": list(m.mesh_dim_names),
                "size": m.size(), "device_type": m.device_type}
    payload = {"abstract": abstract_mesh((16, 16), ("data", "model")).shape}
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=256)
    payload["single"] = desc(make_production_mesh())
    tdist.destroy_process_group()
    tdist.init_process_group("fake", store=FakeStore(), rank=0,
                             world_size=512)
    payload["multi"] = desc(make_production_mesh(multi_pod=True))
    pod = single_pod_mesh_from(range(512))
    payload["single_pod_from"] = desc(pod)
    payload["single_pod_ranks"] = mesh_ranks(pod)
    tdist.destroy_process_group()
    _dump(payload, 0)


if __name__ == "__main__":
    {"sweep": _worker_sweep, "psum": _worker_psum, "serve": _worker_serve,
     "mesh": _worker_mesh}[sys.argv[1]]()
