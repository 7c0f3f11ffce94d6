"""Training CLI (the end-to-end entry point), the port of the JAX package's
`repro/launch/train.py`: same flags, defaults and JSON keys, plus
--device.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-7b --smoke --steps 200 --ckpt-dir runs/ckpt

--smoke trains the reduced config (CPU-trainable with --device cpu).
The run is on the card; --device cpu runs it on the CPU (the one flag
the JAX package's CLI lacks).  --fail-at N injects a failure at step N
(the process exits non-zero); rerunning with the same --ckpt-dir resumes
from the newest complete checkpoint.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..configs import ARCHS, RunConfig, reduced
from ..data import DataConfig
from ..train import train
from ..train.fault_tolerance import FailureInjector


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-trainable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optimizer", default="adamw")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, default=0,
                    help="inject a failure at this step (FT demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    return ap.parse_args(argv)


def run(args: argparse.Namespace):
    """The training run the flags describe: (cfg, TrainResult)."""
    cfg = ARCHS[args.arch]
    if args.smoke:
        cfg = reduced(cfg)
    rc = RunConfig(optimizer=args.optimizer, learning_rate=args.lr,
                   microbatches=args.microbatches, remat=False,
                   attn_impl="naive", warmup_steps=max(1, args.steps // 10))
    dc = DataConfig(seed=args.seed, vocab=cfg.vocab, seq_len=args.seq,
                    global_batch=args.batch)
    injector = (FailureInjector(fail_at_steps=(args.fail_at,))
                if args.fail_at else None)
    return cfg, train(cfg, rc, dc, n_steps=args.steps, seed=args.seed,
                      ckpt_dir=args.ckpt_dir or None,
                      ckpt_every=args.ckpt_every, injector=injector,
                      device=args.device)


def main(argv=None):
    args = parse_args(argv)
    cfg, res = run(args)
    device = torch.device(args.device)
    print(json.dumps({
        "arch": cfg.name, "steps": args.steps,
        "resumed_from": res.resumed_from,
        "loss_first": res.losses[0], "loss_last": res.losses[-1],
        "stragglers": res.straggler_steps,
        "devices": (torch.cuda.device_count() if device.type == "cuda"
                    else 1),
    }, indent=1))


if __name__ == "__main__":
    main()
