"""The counter-RNG contract in PyTorch: threefry2x32, counter normals, packed signs,
SJLT parameters.

Port of ``repro.kernels.common``. Tile (i, j) of every random sketch is a pure
function of (key words, i, j), so the plain PyTorch versions here, the CUDA
kernels (``csrc/rng.cuh``) and the JAX reference all draw the same S.

Words are held in ``int64`` tensors with values in [0, 2**32): PyTorch on the CPU
has no ``uint32`` add, shift or remainder, so every add and shift is followed by
``& MASK32``. Done that way the integer streams match the reference bitwise; the
Gaussian values (``log``/``cos`` from another math library) match to tolerance.
"""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from repro_torch.utils import env as envcfg

MASK32 = 0xFFFFFFFF
_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_PARITY = 0x1BD11BDA
DEFAULT_ROUNDS = 20
TWO_PI_F32 = float(np.float32(2.0 * np.pi))
INV_2_32 = 2.0**-32


def rng_rounds() -> int:
    """Threefry round count for the Gaussian counter stream (``REPRO_RNG_ROUNDS``,
    default 20, a positive multiple of 4). Sign-only streams (Rademacher) always
    use :data:`DEFAULT_ROUNDS`, as in the reference."""
    return envcfg.read_int("REPRO_RNG_ROUNDS", DEFAULT_ROUNDS, positive=True, multiple_of=4)


def _words(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device) & MASK32


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, c0, c1, *, rounds: int = DEFAULT_ROUNDS):
    """Threefry-2x32 (20 rounds is the standard variant).

    Arguments are ints or int64 tensors holding uint32 values, broadcastable;
    tensors must share a device. Returns two int64 tensors of the broadcast shape.
    """
    if rounds <= 0 or rounds % 4:
        raise ValueError(f"threefry rounds must be a positive multiple of 4, got {rounds}")
    device = next((t.device for t in (c0, c1, k0, k1) if isinstance(t, torch.Tensor)), None)
    k0, k1, c0, c1 = (_words(t, device) for t in (k0, k1, c0, c1))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    shape = torch.broadcast_shapes(k0.shape, k1.shape, c0.shape, c1.shape)
    x0 = ((c0 + ks[0]) & MASK32).expand(shape).contiguous()
    x1 = ((c1 + ks[1]) & MASK32).expand(shape).contiguous()
    for block in range(rounds // 4):
        for r in range(4):
            x0.add_(x1).bitwise_and_(MASK32)
            x1 = _rotl(x1, _ROT[(block % 2) * 4 + r])
            x1.bitwise_xor_(x0)
        inj = block + 1
        x0.add_(ks[inj % 3]).bitwise_and_(MASK32)
        x1.add_(ks[(inj + 1) % 3] + inj).bitwise_and_(MASK32)
    return x0, x1


def bits_to_open_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> float32 in (0, 1): round to float32, + 0.5, × 2⁻³²."""
    return (bits.to(torch.float32) + 0.5) * INV_2_32


def counter_normal(k0, k1, c0, c1, *, rounds: int | None = None) -> torch.Tensor:
    """One standard normal per counter pair via threefry + Box-Muller (cos branch).

    ``rounds=None`` resolves :func:`rng_rounds` (the ``REPRO_RNG_ROUNDS`` knob).
    """
    b0, b1 = threefry2x32(k0, k1, c0, c1, rounds=rng_rounds() if rounds is None else rounds)
    u1 = bits_to_open_unit(b0)
    u2 = bits_to_open_unit(b1)
    r = torch.sqrt(-2.0 * torch.log(u1))
    return r * torch.cos(TWO_PI_F32 * u2)


def counter_rademacher(k0, k1, c0, c1, dtype=torch.float32) -> torch.Tensor:
    """One ±1 sign per counter pair (low bit of the first threefry stream)."""
    b0, _ = threefry2x32(k0, k1, c0, c1)
    return (1 - 2 * (b0 & 1)).to(dtype)


def packed_sign_words(k0, k1, rows, wcols) -> torch.Tensor:
    """One word of 32 packed signs per (row, word-column) counter: sign(i, j) is
    bit ``j % 32`` of ``threefry(key, i, j // 32)[0]``."""
    b0, _ = threefry2x32(k0, k1, rows, wcols)
    return b0


def unpack_signs(words: torch.Tensor, bitpos, dtype=torch.float32) -> torch.Tensor:
    """±1 from bit ``bitpos`` of each word (shapes broadcast)."""
    bits = (words >> _words(bitpos, words.device)) & 1
    return (1 - 2 * bits).to(dtype)


def _sign_block(k0, k1, row0: int, wcol0: int, nrows: int, nw: int, device, dtype):
    rows = row0 + torch.arange(nrows, dtype=torch.int64, device=device)[:, None]
    wcols = wcol0 + torch.arange(nw, dtype=torch.int64, device=device)[None, :]
    words = packed_sign_words(k0, k1, rows, wcols)
    bitpos = torch.arange(32, dtype=torch.int64, device=device)
    return unpack_signs(words[:, :, None], bitpos, dtype).reshape(nrows, nw * 32)


def packed_sign_tile(
    k0, k1, row0: int, col0: int, nrows: int, ncols: int, dtype=torch.float32, *, device=None
) -> torch.Tensor:
    """Aligned sign tile: ``col0`` and ``ncols`` must be multiples of 32."""
    if col0 % 32 or ncols % 32:
        raise ValueError(f"packed_sign_tile needs col0, ncols multiples of 32, got {col0}, {ncols}")
    return _sign_block(k0, k1, row0, col0 // 32, nrows, ncols // 32, device, dtype)


def counter_rademacher_block(
    k0, k1, row0: int, col0: int, nrows: int, ncols: int, dtype=torch.float32, *, device=None
) -> torch.Tensor:
    """(nrows, ncols) tile of ±1 packed-contract signs at any ``col0``: draws the
    covering word range (``ncols // 32 + 2`` words per row) and slices the window."""
    w0 = col0 // 32
    signs = _sign_block(k0, k1, row0, w0, nrows, ncols // 32 + 2, device, dtype)
    off = col0 - w0 * 32
    return signs[:, off : off + ncols]


def sjlt_counter_params(k0, k1, row_idx, s: int, m: int, dtype=torch.float32):
    """SJLT buckets and signs for the given *global* row indices.

    Row i's parameters are a pure function of (key, i): for t < s,
    ``b0, b1 = threefry2x32(key, i, t)`` (20 rounds), bucket ``b0 mod m`` and sign
    ``±1`` from the low bit of ``b1`` (1 -> −1), scaled by float32(1/√s). Returns
    ``(buckets, signs)`` of shape (len(row_idx), s): int64 buckets in [0, m), signs
    in ``dtype``.
    """
    r = torch.as_tensor(row_idx, dtype=torch.int64)[:, None]
    t = torch.arange(s, dtype=torch.int64, device=r.device)[None, :]
    b0, b1 = threefry2x32(k0, k1, r, t)
    signs = (1 - 2 * (b1 & 1)).to(dtype)
    return b0 % m, signs * inv_sqrt(s)


def inv_sqrt(m: int) -> float:
    """``1/√m`` rounded to float32, the scale every dense sketch entry carries."""
    return float(np.float32(1.0 / math.sqrt(m)))


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def key_words(key: torch.Tensor) -> tuple[int, int]:
    """The two uint32 words of a (2,) port key as Python ints."""
    if tuple(key.shape) != (2,):
        raise ValueError(f"a key is a (2,) tensor of words, got shape {tuple(key.shape)}")
    return int(key[0]) & MASK32, int(key[1]) & MASK32


@contextlib.contextmanager
def full_fp32_matmul():
    """Run float32 matrix products in true float32 (TF32 off) and restore the flag.

    The plain versions are the reference the kernels are held against on the
    card, and the reference accumulates in full float32.
    """
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def plain_sketch(columns, key: torch.Tensor, A: torch.Tensor, m: int, block_rows: int, row0: int = 0) -> torch.Tensor:
    """S·A (m, d), float32, from ``columns(k0, k1, m, j0, block, device)`` tiles of
    S, drawn ``block_rows`` data rows at a time: the plain version of a dense S·A
    kernel (S materialized block by block, plain matrix products). The float32
    tiles of S and A are multiplied and summed in float64 and rounded once, so
    the kernels are held against the exact S·A of the same S: a float32 sum of
    500,000 products in another order is off by as much as the kernel is.
    ``row0``: the column of S that A's first row meets (S[:, row0 : row0 + n]·A)."""
    k0, k1 = key_words(key)
    n, d = A.shape
    acc = torch.zeros((m, d), dtype=torch.float64, device=A.device)
    for j0 in range(0, n, block_rows):
        blk = A[j0 : j0 + block_rows].to(torch.float64)
        acc += columns(k0, k1, m, row0 + j0, blk.shape[0], A.device).double() @ blk
    return acc.float()


def plain_gram(columns, key: torch.Tensor, A: torch.Tensor, m: int, block_rows: int) -> torch.Tensor:
    """G = (SA)ᵀ(SA) in float32 from :func:`plain_sketch` and one full-float32
    product: the plain version of a fused sketch→Gram kernel."""
    acc = plain_sketch(columns, key, A, m, block_rows)
    with full_fp32_matmul():
        return acc.T @ acc
