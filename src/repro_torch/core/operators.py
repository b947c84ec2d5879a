"""`SketchOp`: the sketch families as frozen linear operators (PyTorch port).

Port of ``repro.core.operators`` for the kinds the port carries so far:
``gaussian``, ``rademacher``, ``srht`` and ``sjlt``. An operator is built once
from ``(SketchSpec, key, n)``:

  * ``columns(j0, block)``       — the (m, block) column tile of S, a pure function
                                   of (key, i, j) (counter RNG, ``kernels/common``;
                                   not for the SJLT, which streams segment sums);
  * ``apply(A)``                 — ``S @ A`` (the plain FWHT for the SRHT, a
                                   segment sum for the SJLT);
  * ``apply_blocked(A, ...)``    — ``S @ A`` streamed over row tiles of A;
  * ``gram_blocked(A, b, ...)``  — ``(G, c) = ((SA)ᵀ(SA), (SA)ᵀ(Sb))`` in one pass
                                   over ``[A | b]``; with ``spec.use_kernel`` the
                                   fused sketch→Gram kernel (``kernels/*/ops.py``).

:func:`gram_batched` gives all q workers' ``(G_k, c_k)``; with ``spec.use_kernel``
that is the multi-worker kernel, launched for all q workers at once (in chunks
of workers when q is large).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.core import sketches as sk
from repro_torch.kernels import common
from repro_torch.kernels.fwht import ref as fref
from repro_torch.kernels.gaussian import ref as gref
from repro_torch.kernels.rademacher import ref as rref
from repro_torch.kernels.sjlt import ref as sref
from repro_torch.utils import prng

DEFAULT_BLOCK_ROWS = 4096

# Kinds of the reference that have no operator in the port yet, with the
# ROADMAP.md entry that ports each.
PENDING = {
    "uniform": "ROADMAP.md Queue 1, 'sampling sketches'",
    "leverage": "ROADMAP.md Queue 1, 'sampling sketches'",
    "hybrid": "ROADMAP.md Queue 1, 'sampling sketches' (hybrid = uniform rows, then an inner sketch)",
}


# ----------------------------------------------------------------------- registry

_REGISTRY: Dict[str, type] = {}


def register(kind: str) -> Callable[[type], type]:
    """Class decorator: make ``kind`` constructible through :func:`make_operator`."""

    def deco(cls: type) -> type:
        _REGISTRY[kind] = cls
        return cls

    return deco


def registered_kinds() -> tuple:
    return tuple(sorted(_REGISTRY))


def _operator_class(spec: sk.SketchSpec) -> type:
    cls = _REGISTRY.get(spec.kind)
    if cls is not None:
        return cls
    if spec.kind in PENDING:
        raise NotImplementedError(
            f"sketch kind {spec.kind!r} is not ported to PyTorch yet: {PENDING[spec.kind]}"
        )
    raise ValueError(f"no SketchOp registered for kind {spec.kind!r}; known: {registered_kinds()}")


def make_operator(spec: sk.SketchSpec, key: torch.Tensor, n: int) -> "SketchOp":
    """Build the frozen ``S ∈ R^{m×n}`` described by ``spec`` from ``key`` ((2,) words)."""
    return _operator_class(spec).build(spec, key, n)


# --------------------------------------------------------------------- shape utils


def _to_2d(X: torch.Tensor, rows: int):
    """View (rows, ...) as (rows, k); returns the 2-D view and the trailing shape."""
    if X.shape[0] != rows:
        raise ValueError(f"operator expects leading dim {rows}, got shape {tuple(X.shape)}")
    return X.reshape(rows, -1), tuple(X.shape[1:])


def _join_b(A: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """Stack ``[A | b]`` in float32 so one pass sketches both."""
    if A.ndim != 2:
        raise ValueError(f"gram_blocked expects A of shape (n, d), got {tuple(A.shape)}")
    if b is None:
        return A.to(torch.float32).contiguous()
    bm = b if b.ndim == 2 else b[:, None]
    return torch.cat([A.to(torch.float32), bm.to(torch.float32)], dim=1)


def _split_gram(Gf: torch.Tensor, d: int, b: Optional[torch.Tensor]):
    """Carve (G, c) out of the joint Gram of [A | b]: G = (SA)ᵀ(SA), c = (SA)ᵀ(Sb)."""
    G = Gf[:d, :d]
    if b is None:
        return G, None
    c = Gf[:d, d:]
    return G, (c[:, 0] if b.ndim == 1 else c)


def _split_gram_batched(Gf: torch.Tensor, d: int, b: Optional[torch.Tensor]):
    """Batched :func:`_split_gram` over (q, d+k, d+k) joint Grams."""
    G = Gf[:, :d, :d]
    if b is None:
        return G, None
    c = Gf[:, :d, d:]
    return G, (c[..., 0] if b.ndim == 1 else c)


# -------------------------------------------------------------------------- base


@dataclasses.dataclass(frozen=True)
class SketchOp:
    """Frozen linear operator S ∈ R^{m×n} (base class).

    Subclasses implement :meth:`columns` and inherit the blocked apply and the
    streamed Gram; kernel-routed kinds override :meth:`gram_blocked` and
    :meth:`gram_batched_kernel`.
    """

    spec: sk.SketchSpec
    key: torch.Tensor
    n: int

    @property
    def m(self) -> int:
        return self.spec.m

    @property
    def shape(self) -> tuple:
        return (self.m, self.n)

    @classmethod
    def build(cls, spec, key, n) -> "SketchOp":
        raise NotImplementedError

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        """All q workers' joint Grams ``(G_k, c_k)`` from one multi-worker kernel
        launch, or ``NotImplemented`` when the kind has none."""
        return NotImplemented

    def columns(self, j0: int, block: int, device=None) -> torch.Tensor:
        """``S[:, j0 : j0+block]`` as an (m, block) float32 tile."""
        raise NotImplementedError(f"{type(self).__name__} does not expose S tiles")

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        """``S @ A`` for A of shape (n, ...). Default: one full-width tile."""
        A2, batch = _to_2d(A, self.n)
        with common.full_fp32_matmul():
            out = self.columns(0, self.n, A.device) @ A2.to(torch.float32)
        return out.to(A.dtype).reshape((self.m,) + batch)

    def _stream_pieces(self, k: int, device):
        """The blocked-streaming triple ``(init, reducer, finish)`` for a width-k
        right-hand side: ``acc = reducer(acc, j0, tile)`` over row tiles, then
        ``S @ X = finish(acc)``. Dense S tiles from :meth:`columns`."""
        init = torch.zeros((self.m, k), dtype=torch.float32, device=device)

        def reducer(acc, j0, tile):
            return acc + self.columns(j0, tile.shape[0], device) @ tile

        return init, reducer, lambda acc: acc

    def _stream(self, X: torch.Tensor, block_rows: int) -> torch.Tensor:
        init, reducer, finish = self._stream_pieces(X.shape[1], X.device)
        bs = max(1, min(block_rows, self.n))
        acc = init
        with common.full_fp32_matmul():
            for j0 in range(0, self.n, bs):
                acc = reducer(acc, j0, X[j0 : j0 + bs].to(torch.float32))
        return finish(acc)

    def apply_blocked(self, A: torch.Tensor, *, block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
        """``S @ A`` streamed over row tiles of A (any ``block_rows``, dividing n or not)."""
        A2, batch = _to_2d(A, self.n)
        return self._stream(A2, block_rows).to(A.dtype).reshape((self.m,) + batch)

    def gram_blocked(
        self,
        A: torch.Tensor,
        b: Optional[torch.Tensor] = None,
        *,
        block_rows: int = DEFAULT_BLOCK_ROWS,
    ):
        """Fused single-pass sketch→Gram: ``(G, c)`` with ``G = (SA)ᵀ(SA)`` (d, d)
        and ``c = (SA)ᵀ(Sb)`` (``None`` when b is), from one streamed pass over
        ``[A | b]``."""
        SAb = self._stream(_join_b(A, b), block_rows)
        with common.full_fp32_matmul():
            Gf = SAb.T @ SAb
        return _split_gram(Gf, A.shape[1], b)


# ----------------------------------------------------------------------- families


def _refuse_apply_kernel(spec: sk.SketchSpec) -> None:
    """``apply`` with ``use_kernel`` needs an S·A kernel the port does not have yet."""
    if spec.use_kernel:
        raise NotImplementedError(
            f"the {spec.kind} S·A kernel is not ported yet (ROADMAP.md Queue 2, 'apply "
            "kernels'); the fused Gram kernel is, through gram_blocked"
        )


@dataclasses.dataclass(frozen=True)
class _DenseCounterOp(SketchOp):
    """A dense family whose S tiles come from ``tiles(k0, k1, m, j0, block, device)``
    and whose fused Gram is ``gram(key, X, m)`` / ``gram_multi(keys, X, m)``."""

    k0: int = 0
    k1: int = 0

    @classmethod
    def build(cls, spec, key, n):
        k0, k1 = common.key_words(key)
        return cls(spec=spec, key=key, n=n, k0=k0, k1=k1)

    def columns(self, j0: int, block: int, device=None) -> torch.Tensor:
        return self.tiles(self.k0, self.k1, self.m, j0, block, device)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        _refuse_apply_kernel(self.spec)
        return super().apply(A)

    def gram_blocked(self, A, b=None, *, block_rows: int = DEFAULT_BLOCK_ROWS):
        if self.spec.use_kernel:
            return _split_gram(self.gram(self.key, _join_b(A, b), self.m), A.shape[1], b)
        return super().gram_blocked(A, b, block_rows=block_rows)

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        return _split_gram_batched(cls.gram_multi(keys, _join_b(A, b), spec.m), A.shape[1], b)


@register("gaussian")
@dataclasses.dataclass(frozen=True)
class GaussianOp(_DenseCounterOp):
    """i.i.d. N(0, 1/m) entries from the counter stream: S[i, j] = f(key, i, j),
    the stream the Gaussian sketch→Gram kernel draws tile by tile."""

    tiles = staticmethod(gref.columns)

    @staticmethod
    def gram(key, X, m):
        from repro_torch.kernels.gaussian import ops

        return ops.gaussian_gram(key, X, m)

    @staticmethod
    def gram_multi(keys, X, m):
        from repro_torch.kernels.gaussian import ops

        return ops.gaussian_gram_multi(keys, X, m)


@register("rademacher")
@dataclasses.dataclass(frozen=True)
class RademacherOp(_DenseCounterOp):
    """i.i.d. ±1/√m entries from the packed counter stream: sign(i, j) is bit
    ``j % 32`` of ``threefry(key, i, j // 32)`` — one threefry call per 32 entries."""

    tiles = staticmethod(rref.columns)

    @staticmethod
    def gram(key, X, m):
        from repro_torch.kernels.rademacher import ops

        return ops.rademacher_gram(key, X, m)

    @staticmethod
    def gram_multi(keys, X, m):
        from repro_torch.kernels.rademacher import ops

        return ops.rademacher_gram_multi(keys, X, m)


# -------------------------------------------------------------------------- srht


def srht_params(keys: torch.Tensor, m: int, n_pad: int):
    """Diagonal key words and sampled Hadamard rows for (..., 2) worker keys: the
    reference's ``kd, kp = split(key)``, ``rows = randint(kp, (m,), 0, n_pad)``,
    bit for bit (jax's partitionable threefry, ``utils/prng.py``)."""
    if n_pad >= 2**31:
        raise ValueError(f"the SRHT samples int32 row ids; n_pad = {n_pad} is too large")
    halves = prng.split(keys)
    return halves[..., 0, :], prng.randint(halves[..., 1, :], (m,), 0, n_pad)


@register("srht")
@dataclasses.dataclass(frozen=True)
class SRHTOp(SketchOp):
    """Randomized Hadamard (ROS): S = (1/√m) · P · H · D on the 2^⌈log n⌉ padding.

    ``apply`` uses the O(n log n) plain FWHT (``sketches._fwht``); ``columns``
    builds Hadamard tiles H[r, j] = (−1)^popcount(r & j) on the fly (the closed
    form the SRHT sketch→Gram kernel draws), which is what makes blocked and
    streamed application possible without the full transform.
    """

    kd0: int = 0  # diagonal key words (D)
    kd1: int = 0
    rows: torch.Tensor = None  # (m,) sampled Hadamard rows, with replacement
    n_pad: int = 0

    @classmethod
    def build(cls, spec, key, n):
        n_pad = sk.next_pow2(n)
        kd, rows = srht_params(key, spec.m, n_pad)
        kd0, kd1 = common.key_words(kd)
        return cls(spec=spec, key=key, n=n, kd0=kd0, kd1=kd1, rows=rows, n_pad=n_pad)

    def _signs(self, j: torch.Tensor) -> torch.Tensor:
        """Rademacher diagonal D at the global coordinates j."""
        return fref.diagonal(self.kd0, self.kd1, j)

    def columns(self, j0: int, block: int, device=None) -> torch.Tensor:
        return fref.columns(self.kd0, self.kd1, self.rows, j0, block, device)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        _refuse_apply_kernel(self.spec)
        A2, batch = _to_2d(A, self.n)
        j = torch.arange(self.n, dtype=torch.int64, device=A.device)
        DA = A2.to(torch.float32) * self._signs(j)[:, None]
        if self.n_pad != self.n:
            DA = torch.cat([DA, DA.new_zeros((self.n_pad - self.n, DA.shape[1]))])
        HDA = sk._fwht(DA)
        out = HDA[self.rows.to(A.device)] * common.inv_sqrt(self.m)
        return out.to(A.dtype).reshape((self.m,) + batch)

    def gram_blocked(self, A, b=None, *, block_rows: int = DEFAULT_BLOCK_ROWS):
        if self.spec.use_kernel:
            from repro_torch.kernels.fwht import ops

            kw = torch.tensor([self.kd0, self.kd1], dtype=torch.int64)
            return _split_gram(ops.srht_gram(kw, self.rows, _join_b(A, b)), A.shape[1], b)
        # As the reference: one FWHT apply, then the small (m, d+k) Gram; streamed
        # closed-form tiles would trade O(n log n) for O(n·m) work per column.
        SAb = self.apply(_join_b(A, b)).to(torch.float32)
        with common.full_fp32_matmul():
            return _split_gram(SAb.T @ SAb, A.shape[1], b)

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        from repro_torch.kernels.fwht import ops

        kd, rows = srht_params(keys, spec.m, sk.next_pow2(A.shape[0]))
        return _split_gram_batched(ops.srht_gram_multi(kd, rows, _join_b(A, b)), A.shape[1], b)


# -------------------------------------------------------------------------- sjlt


@register("sjlt")
@dataclasses.dataclass(frozen=True)
class SJLTOp(SketchOp):
    """Sparse JL: s nonzeros (±1/√s) per input coordinate, counter-derived per row.

    Row parameters come from ``common.sjlt_counter_params``, the same draw the
    SJLT sketch→Gram kernel makes in-core, so kernel and plain paths share S.
    """

    k0: int = 0
    k1: int = 0

    @classmethod
    def build(cls, spec, key, n):
        k0, k1 = common.key_words(key)
        return cls(spec=spec, key=key, n=n, k0=k0, k1=k1)

    def _params(self, row_idx: torch.Tensor):
        return common.sjlt_counter_params(self.k0, self.k1, row_idx, self.spec.s, self.m)

    def _segment_apply(self, A2: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
        buckets, signs = self._params(row_idx)
        return sref.sjlt_apply(A2, buckets, signs, self.m)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        _refuse_apply_kernel(self.spec)
        A2, batch = _to_2d(A, self.n)
        rows = torch.arange(self.n, dtype=torch.int64, device=A.device)
        out = self._segment_apply(A2.to(torch.float32), rows)
        return out.to(A.dtype).reshape((self.m,) + batch)

    def _stream_pieces(self, k: int, device):
        init = torch.zeros((self.m, k), dtype=torch.float32, device=device)

        def reducer(acc, j0, tile):
            rows = j0 + torch.arange(tile.shape[0], dtype=torch.int64, device=device)
            return acc + self._segment_apply(tile, rows)

        return init, reducer, lambda acc: acc

    def gram_blocked(self, A, b=None, *, block_rows: int = DEFAULT_BLOCK_ROWS):
        if self.spec.use_kernel:
            from repro_torch.kernels.sjlt import ops

            return _split_gram(ops.sjlt_gram(self.key, _join_b(A, b), self.m, self.spec.s), A.shape[1], b)
        return super().gram_blocked(A, b, block_rows=block_rows)

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        from repro_torch.kernels.sjlt import ops

        # The worker key words are the SJLT's own words: no split, as build() does.
        Gf = ops.sjlt_gram_multi(keys, _join_b(A, b), spec.m, spec.s)
        return _split_gram_batched(Gf, A.shape[1], b)


# --------------------------------------------------------------- functional API


def gram_blocked(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
):
    """Fused single-pass ``(G, c) = ((SA)ᵀ(SA), (SA)ᵀ(Sb))`` — registry-dispatched."""
    return make_operator(spec, key, A.shape[0]).gram_blocked(A, b, block_rows=block_rows)


def gram_batched(
    spec: sk.SketchSpec,
    keys: torch.Tensor,
    A: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
):
    """All q workers' fused Grams ``(Gs, cs)``, shapes (q, d, d) and (q, d[, k]);
    ``cs`` is None when b is. ``keys``: (q, 2) words (``prng.worker_keys``).

    With ``spec.use_kernel`` this is the multi-worker kernel, launched for all q
    workers at once (in chunks of ``kernels.cuda.worker_chunk`` workers on the
    card), whose worker slices are bitwise equal to the per-key kernel path;
    otherwise a loop of per-key streamed Grams.
    """
    cls = _operator_class(spec)
    if spec.use_kernel:
        fused = cls.gram_batched_kernel(spec, keys, A, b)
        if fused is not NotImplemented:
            return fused
    n = A.shape[0]
    outs = [make_operator(spec, k, n).gram_blocked(A, b, block_rows=block_rows) for k in keys]
    Gs = torch.stack([G for G, _ in outs])
    return Gs, (None if b is None else torch.stack([c for _, c in outs]))
