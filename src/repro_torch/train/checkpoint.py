"""Sharded checkpointing with atomic manifests (fault tolerance core), in
the JAX package's on-disk format, key for key: a checkpoint written by
either package restores in the other.

Layout:
  <dir>/step_000123/
    manifest.json            # keys, shapes, dtypes, step, extra, status
    shard_<host>.npz         # this host's leaves, keyed by tree path

Keys are tree paths joined with "/" ("0/slots/1/attn/wq": element 0 of
the saved tuple, then dict keys and list indices, `tree.flatten_with_
paths`); bfloat16 leaves are stored as their uint16 bits (npz has no
bfloat16), other dtypes as they are.

Protocol: write the shard -> fsync -> rename, then the manifest last
(atomic rename).  A checkpoint without a manifest is incomplete and
ignored on restore, so a crash mid-save never corrupts the restore path.
`latest_step` + `restore` implement auto-resume; `restore_resharded`
re-places the restored tree (elastic scaling after node loss).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from ..tree import flatten_with_paths, rebuild


def _to_storable(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_storable(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype == np.uint16:
        t = torch.tensor(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.tensor(arr).to(like.dtype)
    return t.to(like.device, copy=True)     # a tensor of its own


def _step_dir(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def save(ckpt_dir: str, step: int, tree, host_id: int = 0,
         extra: dict | None = None) -> str:
    """Save this host's leaves of `tree` at `step`; returns the step's
    directory."""
    step_dir = _step_dir(ckpt_dir, step)
    os.makedirs(step_dir, exist_ok=True)
    arrays = {k: _to_storable(v)
              for k, v in flatten_with_paths(tree).items()}
    shard_path = os.path.join(step_dir, f"shard_{host_id:05d}.npz")
    tmp = shard_path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, shard_path)

    # manifest last (commit point); only host 0 writes it
    if host_id == 0:
        manifest = {
            "step": step,
            "keys": sorted(arrays.keys()),
            "shapes": {k: list(v.shape) for k, v in arrays.items()},
            "dtypes": {k: str(v.dtype) for k, v in arrays.items()},
            "extra": extra or {},
            "status": "complete",
        }
        mtmp = os.path.join(step_dir, "manifest.json.tmp")
        with open(mtmp, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(mtmp, os.path.join(step_dir, "manifest.json"))
    return step_dir


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a complete manifest (incomplete saves skipped)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name.split("_")[1]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, name, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like_tree, host_id: int = 0):
    """(tree, extra): new tensors structured, typed and placed like
    `like_tree`'s leaves, from the checkpoint at `step`."""
    step_dir = _step_dir(ckpt_dir, step)
    with open(os.path.join(step_dir, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["status"] != "complete":
        raise ValueError(f"{step_dir}: checkpoint is not complete")
    like = flatten_with_paths(like_tree)
    with np.load(os.path.join(step_dir, f"shard_{host_id:05d}.npz")) as shard:
        restored = []
        for k, proto in like.items():
            arr = shard[k]
            if tuple(arr.shape) != tuple(proto.shape):
                raise ValueError(f"{k}: saved shape {arr.shape}, want "
                                 f"{tuple(proto.shape)}")
            restored.append(_from_storable(arr, proto))
    return rebuild(like_tree, restored), manifest.get("extra", {})


def restore_resharded(ckpt_dir: str, step: int, like_tree, put_fn=None,
                      host_id: int = 0):
    """Elastic restore: load full tensors, then re-place them with
    `put_fn` (a function of the tree, e.g. moving it to the surviving
    devices)."""
    tree, extra = restore(ckpt_dir, step, like_tree, host_id)
    if put_fn is not None:
        tree = put_fn(tree)
    return tree, extra


def gc_old(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest `keep` step directories."""
    if not os.path.isdir(ckpt_dir):
        return
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
                   if n.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(_step_dir(ckpt_dir, s), ignore_errors=True)
