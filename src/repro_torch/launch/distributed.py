"""Multi-process distributed sweeps on `torch.distributed`: process-group
init and the global row mesh (the port of the JAX package's
`launch/distributed.py`).

The sweep engine (`repro_torch.core.sweep`) can split its flattened row
batches over a 1-D row mesh.  Here N cooperating OS processes (ranks)
join one process group, build ONE row mesh over every rank, and evaluate
each sweep tile SPMD: every rank enumerates the same grid (cheap host
numpy), moves to its device only the row shard it owns, and all-gathers
only the per-row output columns (the sweep's output matrix — never the
cost fields inside the kernel) so that every rank runs the identical
argmin/verdict reduction.  Rows are independent, so a rank's results are
bit for bit the unsharded engine's.

Each rank has ONE device: `cuda:<local id>` when the group runs NCCL, the
CPU when it runs gloo.  So `distributed_info()` reports as many global
devices as processes and one local device per process (a JAX process may
own several devices; a rank never does).  NCCL will not put two ranks on
one GPU: ranks that share a card run a gloo group (`device="cpu"`) and
an engine on the card (`distributed_engine(device="cuda")`), gathering
the output columns on the host.

Initialization is idempotent and env-var driven so launchers stay thin:

    REPRO_COORDINATOR=10.0.0.1:8476 REPRO_NUM_PROCESSES=8 \\
    REPRO_PROCESS_ID=$RANK python my_sweep.py

    from repro_torch.launch import distributed as dist
    dist.initialize()                    # no-op when unconfigured
    engine = dist.distributed_engine(chunk_rows=65536)

Explicit arguments always win over the env vars.  The group's backend
follows `device`: NCCL for "cuda" (the default), gloo for "cpu"; a
"cuda" group on a torch without a CUDA device raises (no fallback).
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .mesh import backend_device_type, mesh_ranks, row_mesh

# Env vars consumed by `initialize()` (explicit args take precedence).
ENV_COORDINATOR = "REPRO_COORDINATOR"
ENV_NUM_PROCESSES = "REPRO_NUM_PROCESSES"
ENV_PROCESS_ID = "REPRO_PROCESS_ID"

# the device `initialize` gave this process (None: it did not run)
_RANK_DEVICE: torch.device | None = None


def _env_int(value, var: str):
    if value is not None:
        return int(value)
    raw = os.environ.get(var)
    return int(raw) if raw else None


def is_initialized() -> bool:
    """True when this process belongs to a default process group
    (whether this module or other code created it)."""
    return dist.is_available() and dist.is_initialized()


def _rank_device_for(device, process_id: int, local_device_ids):
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev, "gloo"
    if dev.type != "cuda":
        raise ValueError(f"a rank runs on cuda or cpu, got {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("distributed.initialize runs on 'cuda' (NCCL) by "
                           "default and this torch has no CUDA device; pass "
                           "device='cpu' for a gloo group on the CPU")
    if local_device_ids is not None:
        ids = ([local_device_ids] if isinstance(local_device_ids, int)
               else list(local_device_ids))
        index = ids[0]
    else:
        index = process_id % torch.cuda.device_count()
    return torch.device("cuda", index), "nccl"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               local_device_ids=None, device="cuda") -> bool:
    """Join this process to (or skip) a multi-process group.

    Resolution order per field: explicit argument, then the REPRO_* env
    var.  Unconfigured (no coordinator anywhere) is the common
    single-process case and is a silent no-op; a coordinator with a
    missing process_id/num_processes is a configuration error and raises.
    Calling again after initialization is a no-op (idempotent), so
    library code may call this defensively.

    The coordinator is "host:port" (or a full "tcp://host:port" URL),
    the rendezvous of `init_process_group(init_method=...)`.  A "cuda"
    rank runs NCCL on `cuda:<local_device_ids[0]>`, else on
    `cuda:<process_id % device_count>`; a "cpu" rank runs gloo.

    Returns True iff the process is part of a multi-process group after
    the call.
    """
    global _RANK_DEVICE
    if is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get(ENV_COORDINATOR) or None)
    if coordinator_address is None:
        return False
    num_processes = _env_int(num_processes, ENV_NUM_PROCESSES)
    process_id = _env_int(process_id, ENV_PROCESS_ID)
    if num_processes is None or process_id is None:
        raise ValueError(
            f"distributed.initialize: coordinator {coordinator_address!r} "
            f"configured but num_processes/process_id missing (set "
            f"{ENV_NUM_PROCESSES} and {ENV_PROCESS_ID}, or pass them "
            f"explicitly)")
    dev, backend = _rank_device_for(device, process_id, local_device_ids)
    if backend == "nccl":
        torch.cuda.set_device(dev)
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id,
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    _RANK_DEVICE = dev
    return num_processes > 1


def rank_device() -> torch.device:
    """This rank's device: the one `initialize` chose; in a group created
    elsewhere, the current CUDA device under NCCL and the CPU otherwise;
    without a group, "cuda" (every entry point's default)."""
    if _RANK_DEVICE is not None and is_initialized():
        return _RANK_DEVICE
    if is_initialized() and backend_device_type() == "cpu":
        return torch.device("cpu")
    if is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cuda")


def distributed_info() -> dict:
    """Process/device topology snapshot for telemetry blocks (serve
    reports, engine cache_info).  One device per rank: global_devices is
    the world size and local_devices is 1."""
    if not is_initialized():
        return {"processes": 1, "process_index": 0, "global_devices": 1,
                "local_devices": 1}
    world = dist.get_world_size()
    return {"processes": world, "process_index": dist.get_rank(),
            "global_devices": world, "local_devices": 1}


def global_row_mesh(axis: str = "rows"):
    """1-D row mesh over EVERY rank of the default group — the name makes
    call sites explicit about wanting the job-spanning mesh."""
    if not is_initialized():
        raise RuntimeError("global_row_mesh needs a process group: call "
                           "distributed.initialize() first")
    return row_mesh(axis=axis)


def is_multihost(mesh) -> bool:
    """Does `mesh` hold a rank other than this one?  Such a mesh needs the
    row split and the output all-gather below."""
    if mesh is None:
        return False
    me = dist.get_rank()
    return any(r != me for r in mesh_ranks(mesh))


def shard_balance(n_rows: int, mesh) -> dict:
    """Row counts per process for an `n_rows`-row batch split evenly over
    `mesh`'s row axis — the shard-balance telemetry the serve report and
    `launch.report.shard_balance_table` render."""
    ranks = mesh_ranks(mesh)
    per_rank, rem = divmod(n_rows, len(ranks))
    if rem:
        raise ValueError(f"{n_rows} rows not aligned to {len(ranks)} shards")
    counts: dict[str, int] = {}
    for r in ranks:
        counts[str(r)] = counts.get(str(r), 0) + per_rank
    return counts


def shard_bounds(n_rows: int, mesh) -> tuple[int, int]:
    """[lo, hi): the rows this rank owns of an `n_rows`-row batch split
    evenly over `mesh`, in the order `gather_rows` reassembles them (the
    rank's index in the mesh's group)."""
    w = mesh.size()
    if n_rows % w:
        raise ValueError(f"{n_rows} rows not aligned to {w} shards")
    per = n_rows // w
    i = dist.get_rank(mesh.get_group())
    return i * per, (i + 1) * per


def host_local_to_global(batch: dict, mesh, axis: str | None = None) -> dict:
    """Turn replicated host (numpy) columns into row-sharded `DTensor`s.

    Every rank holds the full enumeration on host (the grid walk is
    deterministic and cheap); device memory is the scarce resource, so
    each rank moves ONLY its own row slice to its device (the mesh's
    device type: its CUDA device under NCCL, the CPU under gloo), placed
    `Shard(0)` on the row mesh.  Row counts must already be a multiple of
    the mesh size (`core.sweep._pad_len` guarantees it).  `axis` names
    the mesh dim (a 1-D row mesh has one)."""
    from torch.distributed.tensor import DTensor, Shard
    if axis is not None and axis not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis!r}")
    out = {}
    for name, col in batch.items():
        col = np.asarray(col)
        lo, hi = shard_bounds(col.shape[0], mesh)
        local = torch.from_numpy(np.ascontiguousarray(col[lo:hi])).to(
            mesh.device_type)
        out[name] = DTensor.from_local(local, mesh, [Shard(0)],
                                       run_check=False)
    return out


def gather_rows(out: dict, mesh=None) -> dict:
    """All-gather row-sharded output columns so every rank sees the full
    per-row results and runs the identical argmin/verdict reduction.

    `out` maps each name to this rank's (n_local,) column (any device,
    one dtype); the columns travel as one (k, n_local) block on the
    group's device (CUDA under NCCL, the CPU under gloo) through one
    all-gather over `mesh`'s group (default: the whole group), and come
    back as host numpy (n_local * world,) columns in rank order.  This
    is the ONLY cross-rank data movement of a distributed sweep."""
    group = mesh.get_group() if mesh is not None else None
    w = dist.get_world_size(group)
    names = list(out)
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend_device_type() == "cuda" else torch.device("cpu"))
    block = torch.stack([torch.as_tensor(out[k]) for k in names]).to(dev)
    k, n_local = block.shape
    full = torch.empty((w * k, n_local), dtype=block.dtype, device=dev)
    gather = getattr(dist, "all_gather_single", None) or (
        dist.all_gather_into_tensor)
    gather(full, block.contiguous(), group=group)
    cols = full.view(w, k, n_local).permute(1, 0, 2).reshape(k, w * n_local)
    cols = cols.cpu().numpy()
    return {name: cols[i] for i, name in enumerate(names)}


def distributed_engine(chunk_rows: int | None = None,
                       cache_size: int = 16384, device=None):
    """A SweepEngine over the global row mesh: the job-scale entry point.

        dist.initialize()
        engine = dist.distributed_engine(chunk_rows=65536)
        decisions = plan_workload_batched(gemms, engine=engine)

    Every cooperating rank must run the same plan queries in the same
    order (SPMD) — `plan_workload_batched` is deterministic, so that
    falls out for free.  chunk_rows bounds device memory per evaluation.
    `device` is where the rank scores its shard (default: the rank's
    device, `rank_device()`); ranks of a gloo group that share a card
    pass device="cuda".  Without a process group this is the plain
    engine (mesh None)."""
    from ..core.sweep import SweepEngine
    mesh = global_row_mesh() if is_initialized() else None
    return SweepEngine(cache_size=cache_size, mesh=mesh,
                       chunk_rows=chunk_rows,
                       device=device if device is not None else rank_device())
