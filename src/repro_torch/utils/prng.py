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

``split``, ``random_bits`` and ``randint`` follow jax's threefry in its
partitionable mode (``jax_threefry_partitionable``, the default of the jax the
reference runs on): element e of a draw of shape ``shape`` is
``threefry2x32(key, hi(e), lo(e))``, the counter being its flat index e split
into 32-bit halves.
Every function takes one key (2,) or a batch of keys (..., 2), so the q workers'
draws are one call.
"""
from __future__ import annotations

import math

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


def _flat_index(nbatch: int, shape: tuple) -> torch.Tensor:
    """The flat index of each element of a draw of ``shape``, after ``nbatch`` key
    batch axes: the low counter word (the high word is 0 below 2**32 elements)."""
    size = math.prod(shape)
    if size >= 2**32:
        raise ValueError(f"draws of 2**32 or more values are not supported, got shape {shape}")
    return torch.arange(size, dtype=torch.int64).reshape((1,) * nbatch + tuple(shape))


def _draw(key: torch.Tensor, shape: tuple):
    """Both threefry words at each flat index of a draw of ``shape`` under each key of
    a (..., 2) batch: two int64 tensors of shape (..., *shape)."""
    k = torch.as_tensor(key, dtype=torch.int64)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is a (..., 2) tensor of words, got shape {tuple(k.shape)}")
    batch, tail = tuple(k.shape[:-1]), (1,) * len(shape)
    k0, k1 = k[..., 0].reshape(batch + tail), k[..., 1].reshape(batch + tail)
    return threefry2x32(k0, k1, 0, _flat_index(len(batch), shape), rounds=DEFAULT_ROUNDS)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., 2) keys -> (..., num, 2); key i of the
    split is both words of ``threefry2x32(key, 0, i)``."""
    return torch.stack(_draw(key, (num,)), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32-bit ``jax.random.bits``: (..., 2) keys -> (..., *shape) words (int64 holding
    uint32 values), the xor of the two threefry words at each flat index."""
    x0, x1 = _draw(key, tuple(shape))
    return x0 ^ x1


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for words below 2**32, in int64 without overflow: the
    high 16 bits of a contribute only their low 16 bits of product, shifted."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & MASK32


def randint(key: torch.Tensor, shape: tuple, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32: (..., 2) keys ->
    (..., *shape) int64 values in [minval, maxval) (``minval`` when maxval <= minval).

    jax splits the key once more, draws higher and lower words, and folds them into
    the span as ``((hi mod span)·(2**32 mod span) + lo mod span) mod span``, where
    ``2**32 mod span`` is computed as ``(2**16 mod span)**2 mod span`` in uint32
    arithmetic that wraps (so it is 0 for a power-of-two span such as 2**19). Every
    product here wraps the same way.
    """
    lo_i32, hi_i32 = -(2**31), 2**31 - 1
    if not (lo_i32 <= minval <= hi_i32 and lo_i32 <= maxval <= hi_i32):
        raise ValueError(f"randint draws int32 values; got bounds [{minval}, {maxval})")
    halves = split(key)
    higher = random_bits(halves[..., 0, :], shape)
    lower = random_bits(halves[..., 1, :], shape)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    value = (minval + offset % span) & MASK32
    return torch.where(value >= 2**31, value - 2**32, value)


def worker_key(base_key: torch.Tensor, worker_id: int, round_id: int = 0) -> torch.Tensor:
    """Deterministic per-(worker, round) key."""
    return fold_in(fold_in(base_key, round_id), worker_id)


def worker_keys(base_key: torch.Tensor, q: int, round_id: int = 0) -> torch.Tensor:
    """The (q, 2) stack of ``worker_key(base_key, w, round_id)`` for w < q."""
    return fold_in(fold_in(base_key, round_id), torch.arange(q, dtype=torch.int64))
