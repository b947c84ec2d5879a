"""Synthetic LM token pipeline: a learnable affine-bigram language.

Port of ``repro.data.tokens``: tokens[t+1] = (a·tokens[t] + c) mod V with
probability p, else uniform noise, a closed-form function of (seed, step, row)
so any shard of any batch can be made again on its own. The draws are the
reference's (``prng.fold_in``/``split``/``randint``/``bernoulli``, jax's threefry),
and the recurrence wraps in int32 as the reference's does, so the tokens are
bitwise the reference's.
"""
from __future__ import annotations

import torch

from repro_torch.utils import prng
from repro_torch.utils.device import resolve_device


def _wrap_int32(v: torch.Tensor) -> torch.Tensor:
    return torch.remainder(v + 2**31, 2**32) - 2**31


def lm_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int, row_offset: int = 0,
             p_pattern: float = 0.9, device=None) -> dict:
    """One batch {tokens, labels, loss_mask} of rows [row_offset, row_offset + batch)
    on ``device`` (default CUDA): tokens and labels (batch, seq) int64, loss_mask
    float32 ones."""
    dev = resolve_device(device)
    a = 31337 % vocab or 1
    c = 7919 % vocab
    rows = torch.arange(row_offset, row_offset + batch, dtype=torch.int64)
    keys = prng.fold_in(prng.fold_in(prng.prng_key(seed), step), rows)  # (batch, 2)
    k3 = prng.split(keys, 3)  # (batch, 3, 2)
    start = prng.randint(k3[:, 0], (), 0, vocab, device=dev)  # (batch,)
    noise = prng.randint(k3[:, 1], (seq,), 0, vocab, device=dev)  # (batch, seq)
    use_pat = prng.bernoulli(k3[:, 2], p_pattern, (seq,), device=dev)
    tokens = torch.empty((batch, seq), dtype=torch.int64, device=dev)
    tok = start
    for t in range(seq):
        tok = torch.where(use_pat[:, t], torch.remainder(_wrap_int32(a * tok + c), vocab), noise[:, t])
        tokens[:, t] = tok
    return {"tokens": tokens, "labels": tokens, "loss_mask": torch.ones((batch, seq), dtype=torch.float32, device=dev)}


def lm_eval_batch(seed: int, step: int, *, batch: int, seq: int, vocab: int, device=None) -> dict:
    """Held-out split: rows offset by 2^20, disjoint from training's."""
    return lm_batch(seed, step, batch=batch, seq=seq, vocab=vocab, row_offset=1 << 20, device=device)
