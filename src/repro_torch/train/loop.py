"""Training loop: the train step with microbatch gradient accumulation,
checkpoint / auto-resume, straggler watchdog and failure injection (the
JAX package's `train/loop.py` under the same names).

`make_train_step` builds the step the loop runs: gradients by
`torch.autograd.grad` of `models.loss_fn`, the global-norm clip, the
learning-rate schedule and the optimizer's in-place update.  The step
reads nothing on the host: its metrics are device tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..configs.base import ModelConfig, RunConfig
from ..data.pipeline import DataConfig, DataIterator
from ..models import init as model_init
from ..models import loss_fn
from ..optim import linear_warmup_cosine, make_optimizer
from ..optim.adamw import leaf_slices
from ..sharding.constraints import batch_rows
from ..tree import leaves, rebuild
from . import checkpoint as ckpt
from .fault_tolerance import FailureInjector, StragglerWatchdog


def _grads_of(params, batch, cfg: ModelConfig, rc: RunConfig):
    """(loss, [grad of each leaf of params, in leaf order])."""
    plist = list(leaves(params))
    for p in plist:
        p.requires_grad_(True)
    loss, _ = loss_fn(params, batch, cfg, rc)
    grads = torch.autograd.grad(loss, plist, allow_unused=True)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(plist, grads)]


def _microbatch(batch: dict, n: int, j: int) -> dict:
    """Microbatch j of n: rows [j b/n, (j+1) b/n) of each entry (the JAX
    package's reshape to (n, b/n, ...); over the dry run's batch-sharded
    DTensors, that part of each rank's shard:
    `sharding.constraints.batch_rows`)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"batch of {v.shape[0]} does not split into "
                             f"{n} microbatches")
        out[k] = batch_rows(v, n, j)
    return out


def _sq_norm(g):
    """sum(g**2) in f32, one leading-axis slice at a time."""
    return sum(torch.sum(torch.square(s.to(torch.float32)))
               for s, in leaf_slices(g))


def make_train_step(cfg: ModelConfig, rc: RunConfig,
                    total_steps: int = 10_000) -> Callable:
    """(params, opt_state, batch, step) -> (params, opt_state, metrics).

    params and opt_state are updated in place (and returned); metrics
    holds 0-d device tensors "loss", "gnorm" and "lr".  With
    rc.microbatches > 1 the batch's leading dim is split in order and the
    gradients accumulate into f32 buffers, then divide by their count, as
    the JAX package's scan does.  Raises at once for attn_impl="pallas":
    the flash-attention kernel has no backward (nor has the JAX
    package's)."""
    if rc.attn_impl == "pallas":
        raise RuntimeError(
            "attn_impl='pallas' cannot train: the flash-attention kernel "
            "has no backward (the JAX package cannot differentiate its "
            "Pallas kernel either); train with 'flash_jnp' or 'naive'")
    _, opt_update = make_optimizer(rc.optimizer, rc.weight_decay)

    def step_fn(params, opt_state, batch, step):
        mb = rc.microbatches
        if mb > 1:
            grads, loss = None, 0.0
            for j in range(mb):
                l, g = _grads_of(params, _microbatch(batch, mb, j), cfg, rc)
                if grads is None:
                    grads = [torch.zeros_like(
                        p, dtype=torch.float32,
                        memory_format=torch.contiguous_format) for p in g]
                for acc, gi in zip(grads, g):
                    acc.add_(gi)
                del g
                loss = loss + l.to(torch.float32)
            for acc in grads:
                acc.div_(mb)
            loss = loss / mb
        else:
            loss, grads = _grads_of(params, batch, cfg, rc)

        with torch.no_grad():
            # global-norm clip, applied inside the optimizer's f32 cast
            gnorm = torch.sqrt(sum(_sq_norm(g) for g in grads))
            clip = torch.clamp(1.0 / (gnorm + 1e-9), max=1.0)
            lr = linear_warmup_cosine(step, rc.learning_rate,
                                      rc.warmup_steps, total_steps,
                                      device=loss.device)
        params, opt_state = opt_update(params, rebuild(params, grads),
                                       opt_state, lr, grad_scale=clip)
        return params, opt_state, {"loss": loss, "gnorm": gnorm, "lr": lr}

    return step_fn


@dataclasses.dataclass
class TrainResult:
    params: Any
    opt_state: Any
    losses: list
    resumed_from: int | None
    straggler_steps: list


def _check_device(device) -> torch.device:
    """`device` as a torch.device; raises for "cuda" on a torch without a
    CUDA device (no silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("training runs on 'cuda' by default and this "
                           "torch has no CUDA device; pass device='cpu' to "
                           "run on the CPU")
    return device


def train(cfg: ModelConfig, rc: RunConfig, data_cfg: DataConfig,
          n_steps: int, *, seed: int = 0, ckpt_dir: str | None = None,
          ckpt_every: int = 0, injector: FailureInjector | None = None,
          params=None, opt_state=None, device="cuda") -> TrainResult:
    """Single-host training loop with auto-resume.

    If `ckpt_dir` holds a complete checkpoint, training resumes from it
    (params, optimizer state, data cursor): the crash-recovery path.
    Without `params`, the model is drawn by `models.init` from a
    generator on `device` seeded with `seed`."""
    device = _check_device(device)
    opt_init, _ = make_optimizer(rc.optimizer, rc.weight_decay)
    if params is None:
        params = model_init(torch.Generator(device=device).manual_seed(seed),
                            cfg, device=device)
    for leaf in leaves(params):
        if leaf.device.type != device.type:
            raise ValueError(f"params live on {leaf.device}, training runs "
                             f"on {device}")
    if opt_state is None:
        opt_state = opt_init(params)

    start_step = 0
    resumed_from = None
    if ckpt_dir is not None:
        last = ckpt.latest_step(ckpt_dir)
        if last is not None:
            (params, opt_state), _ = ckpt.restore(ckpt_dir, last,
                                                  (params, opt_state))
            start_step = resumed_from = last

    nb = cfg.audio.n_codebooks if cfg.family == "audio" else 0
    it = DataIterator(data_cfg, start_step=start_step, n_codebooks=nb,
                      device=device)
    step_fn = make_train_step(cfg, rc, total_steps=n_steps)
    watchdog = StragglerWatchdog()

    losses, stragglers = [], []
    for step in range(start_step, n_steps):
        if injector is not None:
            injector.check(step)
        batch = next(it)
        watchdog.step_start()
        params, opt_state, metrics = step_fn(params, opt_state, batch, step)
        loss = metrics["loss"].item()           # waits for the step
        if watchdog.step_end():
            stragglers.append(step)
        losses.append(loss)
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            ckpt.save(ckpt_dir, step + 1, (params, opt_state),
                      extra={"data": it.state()})
            ckpt.gc_old(ckpt_dir)
    return TrainResult(params, opt_state, losses, resumed_from, stragglers)
