"""Deterministic synthetic token pipeline, sharded per host, with O(1)
skip-ahead (fault-tolerant resume: a batch is a pure function of (seed,
step, host), so restarting at step N replays nothing), as in the JAX
package's `data/pipeline.py`.

The draws come from a CPU `torch.Generator` seeded from (seed, step,
host_id) through numpy's SeedSequence, not from jax's threefry, so the
stream follows the same law with other numbers (as `init` does): each
row (each codebook of an audio row) starts at a uniform token and
continues x[t+1] = (5 x[t] + 17) mod vocab; 5% of positions are then
replaced by uniform tokens; targets are the tokens shifted by one.  The
batch is drawn on the CPU and moved to `device`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    vocab: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    n_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.n_hosts:
            raise ValueError(f"global_batch {self.global_batch} does not "
                             f"split over {self.n_hosts} hosts")
        return self.global_batch // self.n_hosts


def _generator(cfg: DataConfig, step: int) -> torch.Generator:
    seed = np.random.SeedSequence([cfg.seed, step, cfg.host_id])
    return torch.Generator().manual_seed(
        int(seed.generate_state(1, np.uint64)[0]))


def batch_at_step(cfg: DataConfig, step: int, n_codebooks: int = 0,
                  device="cuda") -> dict:
    """The (deterministic) batch for `step` on this host: {"tokens",
    "targets"}, int64 of shape (host_batch, seq_len), or (host_batch,
    seq_len, n_codebooks) for audio.

    Tokens follow repeated n-gram patterns so tiny models measurably
    learn (loss decreases) in integration tests."""
    gen = _generator(cfg, step)
    b, l = cfg.host_batch, cfg.seq_len
    lead = (b,) if not n_codebooks else (b, n_codebooks)
    x = torch.randint(0, cfg.vocab, lead, generator=gen)
    seq = torch.empty(lead + (l + 1,), dtype=torch.int64)
    for t in range(l + 1):
        seq[..., t] = x
        x = (x * 5 + 17) % cfg.vocab
    if n_codebooks:
        seq = seq.transpose(1, 2)                     # (b, l+1, nb)
    noise = torch.rand(seq.shape, generator=gen) < 0.05
    rnd = torch.randint(0, cfg.vocab, seq.shape, generator=gen)
    seq = torch.where(noise, rnd, seq).to(device)
    return {"tokens": seq[:, :-1], "targets": seq[:, 1:]}


class DataIterator:
    """Stateful wrapper with a checkpointable cursor."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 n_codebooks: int = 0, device="cuda"):
        self.cfg = cfg
        self.step = start_step
        self.n_codebooks = n_codebooks
        self.device = device

    def __next__(self):
        b = batch_at_step(self.cfg, self.step, self.n_codebooks,
                          self.device)
        self.step += 1
        return b

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    @classmethod
    def restore(cls, cfg: DataConfig, state: dict, n_codebooks: int = 0,
                device="cuda"):
        if state["seed"] != cfg.seed:
            raise ValueError(f"seed mismatch on resume: the checkpoint's "
                             f"stream has seed {state['seed']}, the config "
                             f"{cfg.seed}")
        return cls(cfg, start_step=state["step"], n_codebooks=n_codebooks,
                   device=device)


def data_config_for(model: ModelConfig, shape: ShapeConfig,
                    n_hosts: int = 1, host_id: int = 0) -> DataConfig:
    return DataConfig(vocab=model.vocab, seq_len=shape.seq_len,
                      global_batch=shape.global_batch, n_hosts=n_hosts,
                      host_id=host_id)
