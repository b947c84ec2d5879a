#!/usr/bin/env python3
"""The reference's own bfloat16 gap between its token-by-token and its batched prefill
on falcon-mamba-7b, the attention-free Mamba stack, beside each path's distance from
a float32 run of the same weights.

Run from the root of a checkout, on the CPU (the JAX package only):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ssm_gap.py [--layers 64 --width 512]

Builds falcon-mamba-7b in bfloat16 with the reference's weights for key 0,
reduced (``--layers 0``: ``reduced()``, 2 layers at d 64) or cut to ``--layers``
× ``--width`` (the Mamba dims following the width; dt_rank = width / 16), and the
same weights cast to float32 (``A_log`` is float32 in both). On ``--batch`` ×
``--tokens`` tokens of ``lm_batch`` it prints one JSON line of largest |Δlogit|
at the last position: ``repro.models.lm.prefill`` (one ``decode_step`` a token)
against ``batched_prefill`` in bfloat16 (the gap the smoke's ``LM_LOGIT_BOUND``
gates for the families the port serves), each bfloat16 path against the float32
batched prefill, and the float32 paths against each other; and the same four
gaps of the decode state's leaves ("conv", "ssm": the largest over all layers,
then the last layer's).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np


def main() -> int:
    from repro.configs import get_config
    from repro.data import tokens
    from repro.models import lm

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=0)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args()
    cfg = get_config("falcon-mamba-7b")
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers, d_model=args.width, dt_rank=-(-args.width // 16))
    else:
        cfg = cfg.reduced()
    c16, c32 = dataclasses.replace(cfg, dtype="bfloat16"), dataclasses.replace(cfg, dtype="float32")
    p16 = lm.init_params(c16, jax.random.PRNGKey(0))
    p32 = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), p16)
    batch = {"tokens": tokens.lm_batch(20260 + 40, 0, batch=args.batch, seq=args.tokens,
                                       vocab=cfg.vocab_size)["tokens"]}
    out, caches = {}, {}
    for name, c, p in (("bf16", c16, p16), ("f32", c32, p32)):
        out[name, "batched"], caches[name, "batched"] = lm.batched_prefill(p, c, batch)
        out[name, "token"], caches[name, "token"] = lm.prefill(p, c, batch, lm.init_cache(c, args.batch, args.tokens))
    gap = lambda a, b: float(np.abs(np.asarray(out[a], np.float64) - np.asarray(out[b], np.float64)).max())
    truth = ("f32", "batched")

    def leaf_gaps(a, b):
        """Largest |Δ| of each decode-state leaf (all layers) and of the last layer's."""
        f = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)
        return {n: [float(np.abs(f(caches[a][n]) - f(caches[b][n])).max()),
                    float(np.abs(f(caches[a][n][-1]) - f(caches[b][n][-1])).max())] for n in ("conv", "ssm")}
    print(json.dumps({"layers": cfg.num_layers, "d_model": cfg.d_model, "batch": args.batch, "tokens": args.tokens,
                      "bf16_token_vs_batched": gap(("bf16", "token"), ("bf16", "batched")),
                      "bf16_batched_vs_f32": gap(("bf16", "batched"), truth),
                      "bf16_token_vs_f32": gap(("bf16", "token"), truth),
                      "f32_token_vs_batched": gap(("f32", "token"), truth),
                      "logit_rms_f32": float(np.sqrt(np.mean(np.asarray(out[truth], np.float64) ** 2))),
                      "cache_bf16_token_vs_batched": leaf_gaps(("bf16", "token"), ("bf16", "batched")),
                      "cache_bf16_batched_vs_f32": leaf_gaps(("bf16", "batched"), truth),
                      "cache_bf16_token_vs_f32": leaf_gaps(("bf16", "token"), truth),
                      "cache_f32_token_vs_batched": leaf_gaps(("f32", "token"), truth)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
