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

``split``, ``random_bits``, ``randint``, ``permutation``, ``choice``, ``uniform``,
``bernoulli``, ``normal``, ``lognormal``, ``gumbel``, ``gumbel_top_k`` and
``categorical`` follow jax's threefry in its partitionable
mode (``jax_threefry_partitionable``, the default of the jax the reference runs
on): element e of a draw of shape ``shape`` is ``threefry2x32(key, hi(e),
lo(e))``, the counter being its flat index e split into 32-bit halves. The
integer draws take one key (2,) or a batch of keys (..., 2), so the q workers'
draws are one call. A draw runs on ``device`` (default the CPU): the key words
are copied there, and every operation is exact, so the words are the same on
every device.

The float draws (``uniform``, ``bernoulli``, ``gumbel``, ``categorical``) are
bitwise those of jax on the CPU, the platform the reference's tests run on:
``xla_log`` repeats XLA's CPU float32 logarithm operation for operation, since
``torch.log`` differs from it by an ulp on about one input in seven. ``normal``
(√2·erfinv(u), ``xla_erfinv``) is bitwise jax's over every uniform it can draw,
on the CPU and on the card (see :func:`xla_erfinv`); ``lognormal`` takes
``torch.exp`` of it.
"""
from __future__ import annotations

import math
import struct

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


def _draw(key: torch.Tensor, shape: tuple, *, offset: int = 0, device=None):
    """Both threefry words at each flat index of a draw of ``shape`` under each key of
    a (..., 2) batch: two int64 tensors of shape (..., *shape) on ``device``.
    ``offset`` shifts the flat indices, so a draw can be made in pieces: the
    elements ``offset .. offset + prod(shape)`` of a larger draw."""
    k = torch.as_tensor(key, dtype=torch.int64)
    if k.shape[-1:] != (2,):
        raise ValueError(f"a key is a (..., 2) tensor of words, got shape {tuple(k.shape)}")
    size = math.prod(shape)
    if offset + size > 2**64:
        raise ValueError(f"draws of more than 2**64 values are not supported, got shape {shape}")
    batch, tail = tuple(k.shape[:-1]), (1,) * len(shape)
    k0 = k[..., 0].reshape(batch + tail).to(device)
    k1 = k[..., 1].reshape(batch + tail).to(device)
    flat = torch.arange(offset, offset + size, dtype=torch.int64, device=device)
    flat = flat.reshape((1,) * len(batch) + tuple(shape))
    return threefry2x32(k0, k1, flat >> 32, flat & MASK32, rounds=DEFAULT_ROUNDS)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., 2) keys -> (..., num, 2); key i of the
    split is both words of ``threefry2x32(key, 0, i)``."""
    return torch.stack(_draw(key, (num,)), dim=-1)


def random_bits(key: torch.Tensor, shape: tuple, *, offset: int = 0, device=None) -> torch.Tensor:
    """32-bit ``jax.random.bits``: (..., 2) keys -> (..., *shape) words (int64 holding
    uint32 values), the xor of the two threefry words at each flat index."""
    x0, x1 = _draw(key, tuple(shape), offset=offset, device=device)
    return x0 ^ x1


def _mul32(a: torch.Tensor, b) -> torch.Tensor:
    """``a * b mod 2**32`` for words below 2**32, in int64 without overflow: the
    high 16 bits of a contribute only their low 16 bits of product, shifted."""
    return ((a & 0xFFFF) * b + ((((a >> 16) * b) & 0xFFFF) << 16)) & MASK32


def randint(key: torch.Tensor, shape: tuple, minval: int, maxval: int, *, device=None) -> torch.Tensor:
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
    higher = random_bits(halves[..., 0, :], shape, device=device)
    lower = random_bits(halves[..., 1, :], shape, device=device)
    span = (maxval - minval) & MASK32 if maxval > minval else 1
    multiplier = (2**16) % span
    multiplier = ((multiplier * multiplier) & MASK32) % span
    offset = (_mul32(higher % span, multiplier) + lower % span) & MASK32
    value = (minval + offset % span) & MASK32
    return torch.where(value >= 2**31, value - 2**32, value)


def permutation(key: torch.Tensor, n: int, *, device=None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: a permutation of 0..n-1 (int64) on ``device``.
    jax shuffles by sorting: ``ceil(3·ln n / ln(2**32 − 1))`` rounds (2 for n
    from 1,622 to 2.6 million), each splitting the key, drawing 32 random bits
    per element under the second half and stably sorting the elements by them."""
    x = torch.arange(n, dtype=torch.int64, device=device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        halves = split(key)
        key = halves[0]
        bits = random_bits(halves[1], (n,), device=device)
        x = x[torch.sort(bits, stable=True).indices]
    return x


def choice(key: torch.Tensor, n: int, shape: tuple, *, device=None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)`` (uniform, no ``p``):
    int64 indices of 0..n-1 on ``device``, the first prod(shape) entries of
    ``permutation(key, n)``."""
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"cannot take {k} of {n} indices without replacement")
    return permutation(key, n, device=device)[:k].reshape(tuple(shape))


# ------------------------------------------------------------------- float draws

def _f32_const(ieee64_hex: str) -> float:
    """A float32 constant written, as LLVM IR writes it, as the hex of its double."""
    return float(np.float32(struct.unpack(">d", bytes.fromhex(ieee64_hex))[0]))


# XLA's CPU float32 log: the Cephes polynomial of degree 8 on the mantissa, and
# its constants, as XLA's CPU backend emits them.
_LOG_P = tuple(_f32_const(h) for h in (
    "3FB2043760000000", "BFBD7A3700000000", "3FBDE4A340000000", "BFBFCBA9E0000000",
    "3FC23D37E0000000", "BFC555CA00000000", "3FC999D580000000", "BFCFFFFF80000000",
    "3FD5555540000000"))
_LOG_SQRTHF = _f32_const("3FE6A09E60000000")
_LOG_Q1 = _f32_const("BF2BD01060000000")
_LOG_Q2 = _f32_const("3FE6300000000000")
_F32_TINY = float(np.finfo(np.float32).tiny)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a·b + c`` rounded once, as the CPU's fused multiply-add: the
    float64 product of two float32 values is exact."""
    f64 = lambda v: v.double() if isinstance(v, torch.Tensor) else v
    return (f64(a) * f64(b) + f64(c)).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive finite float32 values, bitwise as XLA on the CPU
    computes ``jnp.log``: split x into exponent e and a mantissa in
    [sqrt(1/2), sqrt(2)), evaluate the Cephes polynomial with each multiply-add
    fused (LLVM contracts them on the CPU), then add e·ln 2 in two parts. Only
    the products of the polynomial and of the e·q1 term round differently
    fused; e·q2 and z/2 are exact either way. Values at or below the smallest
    normal float are taken as it, as XLA does; zero, negative, infinite and NaN
    inputs are not handled."""
    x = torch.clamp_min(x.to(torch.float32), _F32_TINY)
    bits = x.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(torch.float32)
    mant = ((bits & -2139095041) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = mant < _LOG_SQRTHF
    xm = (mant - 1.0) + torch.where(low, mant, torch.zeros_like(mant))
    e = e - low.to(torch.float32)
    z = xm * xm
    x3 = z * xm
    p = _LOG_P
    y0, y1, y2 = _fma(xm, p[0], p[1]), _fma(xm, p[3], p[4]), _fma(xm, p[6], p[7])
    y0, y1, y2 = _fma(y0, xm, p[2]), _fma(y1, xm, p[5]), _fma(y2, xm, p[8])
    y = _fma(_fma(y0, x3, y1), x3, y2)
    y = _fma(y, x3, _LOG_Q1 * e)
    return ((xm - 0.5 * z) + y) + _LOG_Q2 * e


def uniform(key: torch.Tensor, shape: tuple, minval: float = 0.0, maxval: float = 1.0, *,
            offset: int = 0, device=None) -> torch.Tensor:
    """float32 ``jax.random.uniform(key, shape, minval=minval, maxval=maxval)`` for one
    (2,) key: the top 23 bits of each word as the mantissa of a float in [1, 2),
    minus 1, then ``max(minval, f·(maxval − minval) + minval)`` with the
    multiply-add fused, as XLA's CPU backend computes it."""
    bits = random_bits(key, tuple(shape), offset=offset, device=device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    return torch.clamp_min(_fma(f, float(hi - lo), float(lo)), float(lo))


def bernoulli(key: torch.Tensor, p: float, shape: tuple, *, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` for a float32 p: ``uniform(key) < p``."""
    return uniform(key, tuple(shape), device=device) < float(np.float32(p))


# XLA's float32 erf_inv (Giles' polynomials in w = −log1p(−x²), one for w < 5 and
# one for w >= 5), its log1p's rational form for small arguments (Cephes), and
# the float32 √2 jax multiplies it by: the constants as XLA's CPU backend emits them.
_ERFINV_LT5 = tuple(float(np.float32(v)) for v in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727, 1.50140941))
_ERFINV_GE5 = tuple(float(np.float32(v)) for v in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613, 0.00943887047, 1.00167406, 2.83297682))
_LOG1P_DEN = tuple(_f32_const(h) for h in (
    "402E2035A0000000", "4054C30B60000000", "406BB865A0000000", "4073519460000000",
    "406B0DB140000000", "404E0F3040000000"))
_LOG1P_NUM = tuple(_f32_const(h) for h in (
    "3F07BC0960000000", "3FDFE818A0000000", "401A509F40000000", "403DE97380000000",
    "404E798EC0000000", "404C8E75A0000000", "40340A2020000000"))
_LOG1P_SMALL = _f32_const("3FDA8279A0000000")  # √2 − 1
_SQRT2_F32 = _f32_const("3FF6A09E60000000")


def _xla_log1p(t: torch.Tensor) -> torch.Tensor:
    """``jnp.log1p`` of float32 t > −1 as XLA's CPU backend computes it: below
    |t| = √2 − 1 the Cephes rational form t − t²/2 + t³·P(t)/Q(t), its Horner
    steps fused; above, ``xla_log(1 + t)`` (the sum rounded first)."""
    z = t * t
    den = torch.ones_like(t)
    for c in _LOG1P_DEN:
        den = _fma(den, t, c)
    num = torch.full_like(t, _LOG1P_NUM[0])
    for c in _LOG1P_NUM[1:]:
        num = _fma(num, t, c)
    small = t + _fma(z, -0.5, (t * z) * (num / den))
    return torch.where(t.abs() < _LOG1P_SMALL, small, xla_log(t + 1.0))


def xla_erfinv(x: torch.Tensor) -> torch.Tensor:
    """erfinv of float32 x in (−1, 1) as XLA's CPU backend computes
    ``lax.erf_inv``: w = −log1p(−x²) (``_xla_log1p``), then Giles' degree-8
    polynomial in w − 2.5 (w < 5) or in √w − 3, its Horner steps fused, times x;
    ±1 gives ±inf. Bitwise XLA's over all 2**23 inputs ``normal`` draws. XLA's
    √w is correctly rounded; torch's float32 ``sqrt`` is not, on the CPU (one
    ulp off on ~0.6% of inputs) nor on CUDA (~0.7%), so the root is taken in
    float64 and rounded once, which is the correctly rounded float32 root."""
    x = x.to(torch.float32)
    lg = _xla_log1p(x * (-x))
    lt = lg > -5.0
    wv = torch.where(lt, -2.5 - lg, torch.sqrt(-lg.double()).float() - 3.0)
    p = None
    for a, b in zip(_ERFINV_LT5, _ERFINV_GE5):
        c = torch.where(lt, torch.tensor(a, device=x.device), torch.tensor(b, device=x.device))
        p = c if p is None else _fma(p, wv, c)
    p = torch.where(x.abs() == 1.0, torch.full_like(p, float("inf")), p)
    return x * p


# jax.scipy.special.ndtri's piecewise rational forms (Cephes), as float32 constants.
_NDTRI_P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
             1.39312609387279679503E1, -1.23916583867381258016E0)
_NDTRI_Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
             -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
             1.59056225126211695515E1, -1.18331621121330003142E0)
_NDTRI_P1 = (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
             4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
             -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4)
_NDTRI_Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
             1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
             -3.80806407691578277194E-2, -9.33259480895457427372E-4)
_NDTRI_P2 = (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
             1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
             3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9)
_NDTRI_Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
             2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
             2.89247864745380683936E-6, 6.79019408009981274425E-9)


def _polyval_fused(coeffs, x: torch.Tensor) -> torch.Tensor:
    """``jnp.polyval`` in float32, its Horner steps fused."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = _fma(y, x, float(np.float32(c)))
    return y


def xla_ndtri(p: torch.Tensor) -> torch.Tensor:
    """float32 ``jax.scipy.special.ndtri`` (the inverse normal CDF) of p in (0, 1), as
    jax computes it on the CPU: Cephes' rational form in w = p − 1/2 for
    exp(−2) < p < 1 − exp(−2), else in 1/z with z = √(−2·log p′), p′ = min(p, 1 − p)
    (one of two forms by z < 8), with ``xla_log`` and fused Horner steps. XLA's
    root is correctly rounded and torch's float32 ``sqrt`` is not (see
    :func:`xla_erfinv`), so z is taken in float64 and rounded once; the result
    is then bitwise jax's over a dense grid of (0, 1)."""
    p = p.to(torch.float32)
    f32 = np.float32
    mcp = torch.where(p > float(f32(-np.expm1(-2.0))), 1.0 - p, p)
    mcp = torch.where(mcp == 0, torch.full_like(mcp, 0.5), mcp)
    w = mcp - 0.5
    ww = w * w
    big = (w + w * ww * (_polyval_fused(_NDTRI_P0, ww) / _polyval_fused(_NDTRI_Q0, ww))) * float(
        -f32(np.sqrt(2.0 * np.pi)))
    z = torch.sqrt((-2.0 * xla_log(mcp)).double()).float()
    first, iz = z - xla_log(z) / z, 1.0 / z
    tiny = first - _polyval_fused(_NDTRI_P2, iz) / _polyval_fused(_NDTRI_Q2, iz) / z
    small = first - _polyval_fused(_NDTRI_P1, iz) / _polyval_fused(_NDTRI_Q1, iz) / z
    x = torch.where(mcp > float(f32(np.exp(-2.0))), big, torch.where(z >= 8.0, tiny, small))
    x = torch.where(p > float(f32(1.0 - np.exp(-2.0))), x, -x)
    return torch.where(p == 0, -math.inf, torch.where(p == 1, math.inf, x))


def normal(key: torch.Tensor, shape: tuple, *, offset: int = 0, device=None) -> torch.Tensor:
    """float32 ``jax.random.normal(key, shape)``: √2·erfinv(u) with u uniform in
    (nextafter(−1, 0), 1) (:func:`xla_erfinv`). ``offset`` shifts the flat
    indices, as for :func:`uniform`: a large draw can be made in pieces."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    return (xla_erfinv(uniform(key, tuple(shape), lo, 1.0, offset=offset, device=device))) * _SQRT2_F32


def lognormal(key: torch.Tensor, shape: tuple, *, device=None) -> torch.Tensor:
    """float32 ``jax.random.lognormal(key, shape=shape)``: exp(normal).
    ``torch.exp`` is not XLA's CPU exp bit for bit; a caller that needs jax's
    values exactly should use the order of the draws (exp is increasing), as
    ``averaging.simulate_straggler_mask`` does."""
    return torch.exp(normal(key, shape, device=device))


def gumbel(key: torch.Tensor, shape: tuple, *, offset: int = 0, device=None) -> torch.Tensor:
    """float32 ``jax.random.gumbel(key, shape)`` in jax's default ``mode="low"``:
    ``-log(-log(u))`` with u uniform in [tiny, 1)."""
    u = uniform(key, shape, _F32_TINY, 1.0, offset=offset, device=device)
    return -xla_log(-xla_log(u))


def gumbel_top_k(key: torch.Tensor, n: int, k: int, *, device=None) -> torch.Tensor:
    """``jax.lax.top_k(jax.random.gumbel(key, (n,)), k)[1]``: k of n indices without
    replacement, largest gumbel first, the lower index first among equal values.

    The gumbel value is a strictly increasing function of the 23 mantissa bits of
    its uniform, so a stable descending sort of those bits gives jax's order
    without computing a logarithm (the tests check the monotony over all 2**23
    values). Equal bits (at n = 500,000 about 15,000 pairs) keep index order."""
    if not 0 <= k <= n:
        raise ValueError(f"cannot take {k} of {n} indices without replacement")
    mant = random_bits(key, (n,), device=device) >> 9
    return torch.sort(mant, descending=True, stable=True).indices[:k]


# Elements of gumbel noise one piece of a categorical draw holds: (m, n) is cut
# into pieces of whole rows, each drawn at its flat offset.
CATEGORICAL_PIECE = 1 << 24


def categorical(key: torch.Tensor, logits: torch.Tensor, m: int) -> torch.Tensor:
    """``jax.random.categorical(key, logits, shape=(m,))`` for float32 logits (n,):
    m draws with replacement, ``argmax(gumbel(key, (m, n)) + logits, axis=1)``.
    The (m, n) noise is drawn in pieces of whole rows (at most
    ``CATEGORICAL_PIECE`` values; counters are the flat index r·n + j, so the
    pieces are exact) on the logits' device. Returns (m,) int64 indices."""
    n = logits.shape[0]
    rows = max(1, CATEGORICAL_PIECE // n)
    out = torch.empty(m, dtype=torch.int64, device=logits.device)
    for r0 in range(0, m, rows):
        r = min(rows, m - r0)
        g = gumbel(key, (r, n), offset=r0 * n, device=logits.device)
        out[r0 : r0 + r] = torch.argmax(g + logits, dim=1)
    return out


def worker_key(base_key: torch.Tensor, worker_id: int, round_id: int = 0) -> torch.Tensor:
    """Deterministic per-(worker, round) key."""
    return fold_in(fold_in(base_key, round_id), worker_id)


def worker_keys(base_key: torch.Tensor, q: int, round_id: int = 0) -> torch.Tensor:
    """The (q, 2) stack of ``worker_key(base_key, w, round_id)`` for w < q."""
    return fold_in(fold_in(base_key, round_id), torch.arange(q, dtype=torch.int64))
