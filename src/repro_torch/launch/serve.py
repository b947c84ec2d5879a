"""Serving launcher: LM generation and sketch-solve job admission on the GPU.

    python -m repro_torch.launch.serve --arch granite-3-8b [--reduced]
    python -m repro_torch.launch.serve --solve --q 16 --backend process --adaptive

LM mode (``--arch``) builds the architecture's model with the reference's
weights for key 0 (``models.lm.init_params``), serves ``--requests`` synthetic
prompts through :class:`repro_torch.serve.Engine` (an encoder-decoder's with
the reference launcher's frames, N(0, 1) under key 0; a VLM's without
patches, as there) and prints the ``arch=`` line
(requests, new tokens, wall time, tokens/s) and the first requests' tokens.
Solve mode (``--solve``) boots a :class:`repro_torch.serve.SolveServer`, admits
``--jobs`` synthetic regression jobs through the asynchronous runtime engine on
the chosen executor backend, and prints per-job and aggregate telemetry
(retries, timeouts, drops, effective q′, simulated makespan, relative error
against the exact solve). The flags are the reference launcher's
(``python -m repro.launch.serve``), and the data are drawn as the reference
draws them (``prng``, jax's draws), plus ``--device`` (default CUDA, an error
without it; ``cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import time

import torch


def _latency_model(args):
    from repro_torch import runtime as rt

    if args.latency == "lognormal":
        return rt.LognormalLatency(seed=args.seed, mean_s=args.mean_s, sigma=0.5)
    if args.latency == "heavytail":
        return rt.HeavyTailLatency(seed=args.seed, scale_s=args.mean_s, alpha=1.5)
    if args.latency == "drift":
        return rt.DriftLatency(seed=args.seed, mean_s=args.mean_s, sigma=0.35, growth=1.3)
    if args.latency == "drop":
        return rt.DropLatency(
            seed=args.seed,
            inner=rt.LognormalLatency(seed=args.seed, mean_s=args.mean_s, sigma=0.5),
            drop_prob=0.2,
        )
    raise ValueError(f"unknown latency model {args.latency!r}")


def solve_main(args) -> int:
    from repro_torch import runtime as rt
    from repro_torch.core import sketches as sk, solve
    from repro_torch.serve import SolveServer
    from repro_torch.utils import prng
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    A = prng.normal(prng.prng_key(args.seed), (args.n, args.d), device=dev)
    x_true = prng.normal(prng.prng_key(args.seed + 1), (args.d,), device=dev)
    b = A @ x_true + 0.1 * prng.normal(prng.prng_key(args.seed + 2), (args.n,), device=dev)
    x_star = solve.lstsq(A, b)
    f_star = float(solve.residual_cost(A, b, x_star))

    spec = sk.SketchSpec(args.sketch, args.m, use_kernel=True)
    cfg = rt.RuntimeConfig(
        deadline_s=args.deadline, max_retries=args.retries,
        target_error=args.target_error, max_threads=args.pool,
    )
    deadline = rt.AdaptiveDeadline(warmup_s=args.deadline) if args.adaptive else None
    server = SolveServer(
        latency=_latency_model(args), config=cfg, backend=args.backend, deadline=deadline, device=dev,
    )

    t0 = time.perf_counter()
    for j in range(args.jobs):
        job = server.submit_solve(A, b, spec, q=args.q, seed=args.seed + 17 * j, error_fn="probe")
        f = float(solve.residual_cost(A, b, torch.as_tensor(job.xbar, dtype=A.dtype).to(dev)))
        rel = (f - f_star) / max(f_star, 1e-30)
        s = job.summary
        print(
            f"job {job.job_id}: q'={s['effective_q']}/{args.q} retries={s['retries']} "
            f"timeouts={s['timeouts']} drops={s['drops']} "
            f"makespan={s['sim_makespan_s']:.2f}s rel_err={rel:.3e}",
            flush=True,
        )
    wall = time.perf_counter() - t0
    agg = server.telemetry()
    print(
        f"backend={agg['backend']} jobs={agg['jobs']} wall={wall:.2f}s "
        f"mean_q'={agg['effective_q_mean']:.1f} retries={agg['retries']} "
        f"timeouts={agg['timeouts']} drops={agg['drops']} "
        f"adaptive_deadline={bool(args.adaptive)} device={dev}",
        flush=True,
    )
    return 0


def lm_main(args) -> int:
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.serve import Engine, ServeConfig
    from repro_torch.utils import prng
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, prng.prng_key(0), device=dev)
    sc = ServeConfig(max_batch=4, max_len=args.prompt_len + args.max_new + 8, temperature=args.temperature)
    engine = Engine(cfg, params, sc, device=dev)
    prompts = [
        list(range(3 + (i % 5), 3 + (i % 5) + args.prompt_len - (i % 4))) for i in range(args.requests)
    ]
    kwargs = {}
    if cfg.encdec:  # the reference launcher's frames: N(0, 1) under the weights' key
        kwargs["frames"] = prng.normal(prng.prng_key(0), (sc.max_batch, cfg.enc_seq, cfg.d_model), device=dev)
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=args.max_new, **kwargs)
    dt = time.perf_counter() - t0  # generate returns host lists: the device is done
    toks = sum(len(o) for o in outs)
    print(f"arch={cfg.name} requests={len(prompts)} new_tokens={toks} wall={dt:.2f}s ({toks / dt:.1f} tok/s) "
          f"device={dev}", flush=True)
    for i, o in enumerate(outs[:4]):
        print(f"  req{i}: prompt={prompts[i][:6]}... -> {o[:12]}", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, help="LM mode: architecture id")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--solve", action="store_true", help="admit sketch-solve jobs")
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--d", type=int, default=32)
    ap.add_argument("--m", type=int, default=256)
    ap.add_argument("--q", type=int, default=16)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--sketch", default="gaussian")
    ap.add_argument("--backend", default="thread", choices=("inline", "thread", "process"))
    ap.add_argument("--pool", type=int, default=4, help="executor pool width")
    ap.add_argument("--latency", default="lognormal", choices=("lognormal", "heavytail", "drift", "drop"))
    ap.add_argument("--mean-s", type=float, default=1.0, help="latency scale/median")
    ap.add_argument("--deadline", type=float, default=2.0)
    ap.add_argument("--retries", type=int, default=2)
    ap.add_argument("--adaptive", action="store_true", help="rolling-p95 deadlines")
    ap.add_argument("--target-error", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="where the model or jobs run (default: cuda; cpu for the CPU)")
    args = ap.parse_args(argv)

    if args.solve:
        return solve_main(args)
    if args.arch is None:
        ap.error("pass --arch <id> (LM serving) or --solve (sketch-solve serving)")
    return lm_main(args)


if __name__ == "__main__":
    raise SystemExit(main())
