"""Keys and per-(worker, round) key derivation, without JAX.

A key is its two uint32 words, held as an ``int64`` tensor of shape (2,) (a
batch of q keys is (q, 2)), always on the CPU: the kernels copy the words to the
device they run on. The words follow ``jax.random``'s threefry keys exactly:

* ``jax.random.PRNGKey(seed)`` has words ``(0, seed mod 2**32)`` for a 32-bit seed;
* ``jax.random.fold_in(k, data)`` is both words of the 20-round
  ``threefry2x32(k0, k1, 0, data)``;

so ``worker_key(base, w, r) = fold_in(fold_in(base, r), w)`` reproduces the
reference's worker keys bit for bit (workers are stateless i.i.d. copies: any
worker can be re-run and redraws the same sketch).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.common import DEFAULT_ROUNDS, MASK32, threefry2x32


def prng_key(seed: int) -> torch.Tensor:
    """The key ``jax.random.PRNGKey(seed)`` makes (default 32-bit mode)."""
    if not -(2**31) <= seed < 2**31:
        raise ValueError(f"seed must fit in 32 signed bits, got {seed}")
    return torch.tensor([0, seed & MASK32], dtype=torch.int64)


def from_key_data(data) -> torch.Tensor:
    """A ``jax.random.key_data`` array (numpy uint32, (..., 2)) as port key words."""
    arr = np.asarray(data)
    if arr.dtype != np.uint32 or arr.shape[-1:] != (2,):
        raise ValueError(f"expected uint32 key data of shape (..., 2), got {arr.dtype} {arr.shape}")
    return torch.from_numpy(arr.astype(np.int64))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: (2,) key and an int or (q,) ints -> (2,) or (q, 2)."""
    data = torch.as_tensor(data, dtype=torch.int64) & MASK32
    x0, x1 = threefry2x32(key[..., 0], key[..., 1], 0, data, rounds=DEFAULT_ROUNDS)
    return torch.stack([x0, x1], dim=-1)


def worker_key(base_key: torch.Tensor, worker_id: int, round_id: int = 0) -> torch.Tensor:
    """Deterministic per-(worker, round) key."""
    return fold_in(fold_in(base_key, round_id), worker_id)


def worker_keys(base_key: torch.Tensor, q: int, round_id: int = 0) -> torch.Tensor:
    """The (q, 2) stack of ``worker_key(base_key, w, round_id)`` for w < q."""
    return fold_in(fold_in(base_key, round_id), torch.arange(q, dtype=torch.int64))
