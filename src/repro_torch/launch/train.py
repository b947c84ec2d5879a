"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [--reduced]``.

Port of ``python -m repro.launch.train``, with its flags (``--steps``,
``--batch``, ``--seq``, ``--lr``, ``--ckpt-dir``, ``--ckpt-every``,
``--accum``, ``--seed``) plus ``--device`` (default CUDA, an error without it;
``cpu`` for the CPU). It trains the architecture from the reference's weights
for key ``--seed`` with AdamW under ``linear_warmup_cosine`` through
:class:`repro_torch.train.Trainer` (resuming from ``--ckpt-dir`` when it holds
a checkpoint) and prints the ``arch=`` line and the logged steps' metrics.
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig, linear_warmup_cosine
    from repro_torch.train import Trainer, TrainerConfig

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", help="CPU-size config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    tc = TrainerConfig(seed=args.seed, batch=args.batch, seq=args.seq, ckpt_dir=args.ckpt_dir,
                       ckpt_every=args.ckpt_every, accum_steps=args.accum, log_every=max(1, args.steps // 20))
    schedule = linear_warmup_cosine(max(1, args.steps // 10), args.steps)
    trainer = Trainer(cfg, AdamWConfig(lr=args.lr), tc, schedule=schedule, device=args.device)
    t0 = time.perf_counter()
    trainer.run(args.steps)
    dt = time.perf_counter() - t0
    print(f"arch={cfg.name} steps={args.steps} wall={dt:.1f}s")
    for h in trainer.history:
        print("  " + " ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in h.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
