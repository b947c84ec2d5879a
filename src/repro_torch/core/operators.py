"""`SketchOp`: the sketch families as frozen linear operators (PyTorch port).

Port of ``repro.core.operators`` for every kind of ``sketches.KINDS``. An
operator is built once from ``(SketchSpec, key, n)`` (and the leverage scores,
for ``leverage``):

  * ``columns(j0, block)``       — the (m, block) column tile of S, a pure function
                                   of (key, i, j) (counter RNG, ``kernels/common``;
                                   not for the SJLT and the hybrid);
  * ``apply(A)``                 — ``S @ A``; with ``spec.use_kernel`` the S·A kernel
                                   of the kind (``kernels/*/ops.py``: the dense
                                   S·A, the SJLT S·A, the FWHT inside the SRHT);
                                   a gather for the sampling kinds; the hybrid
                                   gathers m′ rows and applies its inner operator;
  * ``apply_blocked(A, ...)``    — ``S @ A`` streamed over row tiles of A;
  * ``gram_blocked(A, b, ...)``  — ``(G, c) = ((SA)ᵀ(SA), (SA)ᵀ(Sb))`` in one pass
                                   over ``[A | b]``; with ``spec.use_kernel`` the
                                   fused sketch→Gram kernel of a projection kind;
  * ``adjoint(Y)``               — ``Sᵀ @ Y``: streamed column tiles of S; with
                                   ``spec.use_kernel`` the Gaussian adjoint kernel;
                                   a fixed-order scatter for the sampling kinds
                                   (:func:`_scatter_rows`), the scatter and the
                                   FWHT for the SRHT, a gather for the SJLT;
  * ``apply_with_adjoint(A)``    — ``(S @ A, adjoint)`` for a caller that applies
                                   Sᵀ right after S (the least-norm worker,
                                   gradient compression): a Gaussian with
                                   ``spec.use_kernel`` keeps the S its S·A kernel
                                   draws (where it fits) and its adjoint reads
                                   it; an SJLT with ``spec.use_kernel`` whose
                                   S·A takes row 12b keeps the pair list that
                                   kernel draws and its adjoint gathers from it
                                   (:func:`sjlt_adjoint_kept`); every other kind
                                   returns ``(apply(A), adjoint)``;
  * ``materialize()``            — the explicit S (small problems only).

:func:`gram_batched` gives all q workers' ``(G_k, c_k)`` and :func:`apply_batched`
all q workers' ``S_k A``; with ``spec.use_kernel`` both launch one multi-worker
kernel for all q workers (in chunks of workers when q is large) where the kind
has one. Row draws of the sampling kinds run on the device of the data.
"""
from __future__ import annotations

import dataclasses
import math
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
# (column, t) pairs whose SJLT parameters SJLTOp.adjoint draws at once by default.
SJLT_ADJOINT_PAIRS = 1 << 20


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
    if cls is None:
        raise ValueError(f"no SketchOp registered for kind {spec.kind!r}; known: {registered_kinds()}")
    return cls


def make_operator(spec: sk.SketchSpec, key: torch.Tensor, n: int, *,
                  scores: Optional[torch.Tensor] = None, device=None) -> "SketchOp":
    """Build the frozen ``S ∈ R^{m×n}`` described by ``spec`` from ``key`` ((2,) words).

    ``scores``: the leverage scores (n,), required for ``kind="leverage"`` and
    ignored otherwise, as in the reference: a data-dependent sketch is given its
    statistics so that the operator is fixed. ``device``: where the row draws of
    the sampling kinds run (the device of the data the operator will meet;
    default the CPU). The draws are bitwise the same on every device.
    """
    return _operator_class(spec).build(spec, key, n, scores=scores, device=device)


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
    def build(cls, spec, key, n, *, scores=None, device=None) -> "SketchOp":
        raise NotImplementedError

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        """All q workers' joint Grams ``(G_k, c_k)`` from one multi-worker kernel
        launch, or ``NotImplemented`` when the kind has none."""
        return NotImplemented

    @classmethod
    def apply_batched_kernel(cls, spec, keys, A):
        """All q workers' ``S_k A`` (q, m, ...) from one multi-worker S·A kernel
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
        return _gram_of(self._stream(_join_b(A, b), block_rows), A.shape[1], b)

    def adjoint(self, Y: torch.Tensor, *, block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
        """``Sᵀ @ Y`` for Y of shape (m, ...), streamed over column tiles of S."""
        Y2, batch = _to_2d(Y, self.m)
        Yf = Y2.to(torch.float32)
        bs = max(1, min(block_rows, self.n))
        with common.full_fp32_matmul():
            out = torch.cat([self.columns(j0, min(bs, self.n - j0), Y.device).T @ Yf
                             for j0 in range(0, self.n, bs)])
        return out.to(Y.dtype).reshape((self.n,) + batch)

    def apply_with_adjoint(self, A: torch.Tensor):
        """``(S @ A, adjoint)``, ``adjoint(Y)`` being ``Sᵀ @ Y`` of this operator:
        for a caller that applies both. Default: :meth:`apply` and :meth:`adjoint`."""
        return self.apply(A), self.adjoint

    def materialize(self, dtype=torch.float32, device=None) -> torch.Tensor:
        """Explicit S ∈ R^{m×n} (tests / small problems only): ``S @ I``."""
        return self.apply(torch.eye(self.n, dtype=dtype, device=device))


def _gram_of(SAb: torch.Tensor, d: int, b: Optional[torch.Tensor]):
    """``(G, c)`` from a sketched ``[SA | Sb]`` by one full-float32 matrix product."""
    SAb = SAb.to(torch.float32)
    with common.full_fp32_matmul():
        return _split_gram(SAb.T @ SAb, d, b)


def _gather_joint(A: torch.Tensor, b: Optional[torch.Tensor], rows: torch.Tensor) -> torch.Tensor:
    """``[A | b][rows]`` in float32, gathered from A and b apart (the joined
    (n, d+k) matrix is never made)."""
    rows = rows.to(A.device)
    return _join_b(A[rows], None if b is None else b[rows])


def _scatter_rows(rows: torch.Tensor, Y: torch.Tensor, n: int) -> torch.Tensor:
    """``out = zeros(n, ...); out[rows[t]] += Y[t]`` (the transpose of the gather
    ``X[rows]``), each row's samples added in sample order t, with no atomics.

    On the card ``index_add_`` and its kin add repeated rows with float atomics,
    in an order that changes run to run. Here the samples are sorted stably by
    row; a sample is the r-th of its row (r from 0, in sample order), and pass r
    adds the r-th samples of all rows at once, to distinct rows. There are as
    many passes as the most repeated row has samples: one where the rows are
    distinct. The same code runs on every device, so the sums are the same."""
    rows = rows.to(Y.device)
    order = torch.sort(rows, stable=True).indices
    by_row = rows[order]
    pos = torch.arange(rows.numel(), dtype=torch.int64, device=Y.device)
    first = torch.ones_like(by_row, dtype=torch.bool)
    first[1:] = by_row[1:] != by_row[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), dim=0).values
    out = Y.new_zeros((n,) + tuple(Y.shape[1:]))
    for r in range(int(rank.max()) + 1):
        pick = rank == r
        idx = by_row[pick]
        out[idx] = out[idx] + Y[order[pick]]
    return out


def _gather_rows_reducer(rows: torch.Tensor):
    """Streaming reducer that collects ``X[rows]`` from row tiles: tile rows j0 ..
    j0+len hold the sampled rows that fall in them (O(len(rows)·k) per tile)."""

    def reducer(acc, j0, tile):
        local = rows.to(tile.device) - j0
        hit = (local >= 0) & (local < tile.shape[0])
        acc = acc.clone()
        acc[hit] = acc[hit] + tile[local[hit]]
        return acc

    return reducer


# ----------------------------------------------------------------------- families


def _kernel_apply(fn, A: torch.Tensor, rows: int) -> torch.Tensor:
    """An S·A kernel wrapper ``fn`` on the contiguous (rows, k) float32 view of A;
    its (..., m, k) result takes A's dtype and trailing shape."""
    A2, batch = _to_2d(A, rows)
    out = fn(A2.to(torch.float32).contiguous())
    return out.to(A.dtype).reshape(out.shape[:-1] + batch)


@dataclasses.dataclass(frozen=True)
class _DenseCounterOp(SketchOp):
    """A dense family whose S tiles come from ``tiles(k0, k1, m, j0, block, device)``,
    whose S·A kernel is ``sketch(key, X, m)`` / ``sketch_multi(keys, X, m)`` and
    whose fused Gram is ``gram(key, X, m)`` / ``gram_multi(keys, X, m)``."""

    k0: int = 0
    k1: int = 0

    @classmethod
    def build(cls, spec, key, n, *, scores=None, device=None):
        k0, k1 = common.key_words(key)
        return cls(spec=spec, key=key, n=n, k0=k0, k1=k1)

    def columns(self, j0: int, block: int, device=None) -> torch.Tensor:
        return self.tiles(self.k0, self.k1, self.m, j0, block, device)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        if self.spec.use_kernel:
            return _kernel_apply(lambda X: self.sketch(self.key, X, self.m), A, self.n)
        return super().apply(A)

    def gram_blocked(self, A, b=None, *, block_rows: int = DEFAULT_BLOCK_ROWS):
        if self.spec.use_kernel:
            return _split_gram(self.gram(self.key, _join_b(A, b), self.m), A.shape[1], b)
        return super().gram_blocked(A, b, block_rows=block_rows)

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        return _split_gram_batched(cls.gram_multi(keys, _join_b(A, b), spec.m), A.shape[1], b)

    @classmethod
    def apply_batched_kernel(cls, spec, keys, A):
        return _kernel_apply(lambda X: cls.sketch_multi(keys, X, spec.m), A, A.shape[0])


@register("gaussian")
@dataclasses.dataclass(frozen=True)
class GaussianOp(_DenseCounterOp):
    """i.i.d. N(0, 1/m) entries from the counter stream: S[i, j] = f(key, i, j),
    the stream the Gaussian S·A and sketch→Gram kernels draw tile by tile."""

    tiles = staticmethod(gref.columns)

    def adjoint(self, Y: torch.Tensor, *, block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
        if self.spec.use_kernel:
            from repro_torch.kernels.gaussian import ops

            Y2, batch = _to_2d(Y, self.m)
            out = ops.gaussian_adjoint(self.key, Y2.to(torch.float32).contiguous(), self.n)
            return out.to(Y.dtype).reshape((self.n,) + batch)
        return super().adjoint(Y, block_rows=block_rows)

    def apply_with_adjoint(self, A: torch.Tensor):
        """With ``spec.use_kernel`` and an S that fits the scratch
        (``cuda.keeps_sketch``, by the shapes alone): the S·A kernel also writes
        the S it draws, and the adjoint returned reads it back
        (``ops.gaussian_adjoint_kept``) instead of drawing it again. S lives as
        long as that adjoint."""
        from repro_torch.kernels import cuda
        from repro_torch.kernels.gaussian import ops

        if not (self.spec.use_kernel and cuda.keeps_sketch(self.m, self.n)):
            return super().apply_with_adjoint(A)
        kept = []

        def sketch(X):
            SX, S = ops.gaussian_sketch_keep(self.key, X, self.m)
            kept.append(S)
            return SX

        SA = _kernel_apply(sketch, A, self.n)
        S = kept[0]

        def adjoint(Y: torch.Tensor, *, block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
            Y2, batch = _to_2d(Y, self.m)
            out = ops.gaussian_adjoint_kept(S, Y2.to(torch.float32).contiguous(), self.n)
            return out.to(Y.dtype).reshape((self.n,) + batch)

        return SA, adjoint

    @staticmethod
    def sketch(key, X, m):
        from repro_torch.kernels.gaussian import ops

        return ops.gaussian_sketch(key, X, m)

    @staticmethod
    def sketch_multi(keys, X, m):
        from repro_torch.kernels.gaussian import ops

        return ops.gaussian_sketch_multi(keys, X, m)

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
    def sketch(key, X, m):
        from repro_torch.kernels.rademacher import ops

        return ops.rademacher_sketch(key, X, m)

    @staticmethod
    def sketch_multi(keys, X, m):
        from repro_torch.kernels.rademacher import ops

        return ops.rademacher_sketch_multi(keys, X, m)

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

    ``apply`` is D·A, zero rows up to n_pad, the O(n log n) FWHT, then the m
    sampled rows scaled by 1/√m: with ``spec.use_kernel`` one call into the fused
    SRHT forward kernel (``fwht.ops.srht_forward``, its plain version on a CPU
    tensor), else that plain composition; ``adjoint`` is its transpose: a
    scatter of the m rows into n_pad (:func:`_scatter_rows`), the FWHT (the CUDA
    FWHT kernel with ``spec.use_kernel``), the first n rows times D and 1/√m.
    ``columns`` builds Hadamard tiles H[r, j] = (−1)^popcount(r & j) on the fly
    (the closed form the SRHT sketch→Gram kernel draws), which is what makes
    blocked and streamed application possible without the full transform.
    """

    kd0: int = 0  # diagonal key words (D)
    kd1: int = 0
    rows: torch.Tensor = None  # (m,) sampled Hadamard rows, with replacement
    n_pad: int = 0

    @classmethod
    def build(cls, spec, key, n, *, scores=None, device=None):
        n_pad = sk.next_pow2(n)
        kd, rows = srht_params(key, spec.m, n_pad)
        kd0, kd1 = common.key_words(kd)
        return cls(spec=spec, key=key, n=n, kd0=kd0, kd1=kd1, rows=rows, n_pad=n_pad)

    def _signs(self, j: torch.Tensor) -> torch.Tensor:
        """Rademacher diagonal D at the global coordinates j."""
        return fref.diagonal(self.kd0, self.kd1, j)

    def columns(self, j0: int, block: int, device=None) -> torch.Tensor:
        return fref.columns(self.kd0, self.kd1, self.rows, j0, block, device)

    def _fwht(self, X: torch.Tensor) -> torch.Tensor:
        """H·X over the n_pad rows: the FWHT kernel with ``spec.use_kernel`` (the
        plain version on a CPU tensor), else the plain ``sketches._fwht``."""
        if self.spec.use_kernel:
            from repro_torch.kernels.fwht import ops

            return ops.fwht(X.contiguous())
        return sk._fwht(X)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        A2, batch = _to_2d(A, self.n)
        if self.spec.use_kernel:
            from repro_torch.kernels.fwht import ops

            forward = ops.srht_forward
        else:
            forward = fref.srht_forward
        out = forward(self.kd0, self.kd1, self.rows, A2.to(torch.float32).contiguous(), self.n_pad)
        return out.to(A.dtype).reshape((self.m,) + batch)

    def adjoint(self, Y: torch.Tensor, *, block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
        # Sᵀ = (1/√m)·D·Hᵀ·Pᵀ with H symmetric; Pᵀ scatters (the sampled rows repeat).
        Y2, batch = _to_2d(Y, self.m)
        HZ = self._fwht(_scatter_rows(self.rows, Y2.to(torch.float32), self.n_pad))[: self.n]
        j = torch.arange(self.n, dtype=torch.int64, device=Y.device)
        out = HZ * self._signs(j)[:, None] * common.inv_sqrt(self.m)
        return out.to(Y.dtype).reshape((self.n,) + batch)

    def gram_blocked(self, A, b=None, *, block_rows: int = DEFAULT_BLOCK_ROWS):
        if self.spec.use_kernel:
            from repro_torch.kernels.fwht import ops

            kw = torch.tensor([self.kd0, self.kd1], dtype=torch.int64)
            return _split_gram(ops.srht_gram(kw, self.rows, _join_b(A, b)), A.shape[1], b)
        # As the reference: one FWHT apply, then the small (m, d+k) Gram; streamed
        # closed-form tiles would trade O(n log n) for O(n·m) work per column.
        return _gram_of(self.apply(_join_b(A, b)), A.shape[1], b)

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        from repro_torch.kernels.fwht import ops

        kd, rows = srht_params(keys, spec.m, sk.next_pow2(A.shape[0]))
        return _split_gram_batched(ops.srht_gram_multi(kd, rows, _join_b(A, b)), A.shape[1], b)


# ------------------------------------------------------------------ row sampling


@dataclasses.dataclass(frozen=True)
class _RowSamplingOp(SketchOp):
    """S = diag(scales) · P with P picking ``rows``: ``apply`` is a gather and a
    scale, ``gram_blocked`` gathers the m rows of ``[A | b]``, scales them and
    takes one full-float32 Gram (the reference's streamed gather computes the
    same rows), ``adjoint`` scales and scatters (:func:`_scatter_rows`)."""

    rows: torch.Tensor = None  # (m,)

    def _row_scales(self, device) -> torch.Tensor:
        """float32 scale of each sampled row, (m,) or a scalar."""
        raise NotImplementedError

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        scl = self._row_scales(A.device).to(A.dtype)
        return A[self.rows.to(A.device)] * scl.reshape(scl.shape + (1,) * (A.ndim - 1))

    def columns(self, j0: int, block: int, device=None) -> torch.Tensor:
        j = j0 + torch.arange(block, dtype=torch.int64, device=device)
        onehot = (self.rows.to(device)[:, None] == j[None, :]).to(torch.float32)
        scl = self._row_scales(device).to(torch.float32)
        return onehot * (scl[:, None] if scl.ndim else scl)

    def _stream_pieces(self, k: int, device):
        init = torch.zeros((self.m, k), dtype=torch.float32, device=device)
        scl = self._row_scales(device).to(torch.float32)
        finish = lambda acc: acc * (scl[:, None] if scl.ndim else scl)
        return init, _gather_rows_reducer(self.rows), finish

    def gram_blocked(self, A, b=None, *, block_rows: int = DEFAULT_BLOCK_ROWS):
        scl = self._row_scales(A.device).to(torch.float32)
        SAb = _gather_joint(A, b, self.rows) * (scl[:, None] if scl.ndim else scl)
        return _gram_of(SAb, A.shape[1], b)

    def adjoint(self, Y: torch.Tensor, *, block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
        Y2, batch = _to_2d(Y, self.m)
        scl = self._row_scales(Y.device).to(Y2.dtype)
        out = _scatter_rows(self.rows, Y2 * (scl[:, None] if scl.ndim else scl), self.n)
        return out.reshape((self.n,) + batch)


@register("uniform")
@dataclasses.dataclass(frozen=True)
class UniformOp(_RowSamplingOp):
    """Uniform row sampling scaled by √(n/m) so E[SᵀS] = I. With replacement the
    rows are ``randint(key, (m,), 0, n)``; without, the gumbel top-m
    (``prng.gumbel_top_k``), both bitwise the reference's picks."""

    @classmethod
    def build(cls, spec, key, n, *, scores=None, device=None):
        if spec.replacement:
            rows = prng.randint(key, (spec.m,), 0, n, device=device)
        else:
            rows = prng.gumbel_top_k(key, n, spec.m, device=device)
        return cls(spec=spec, key=key, n=n, rows=rows)

    def _row_scales(self, device) -> torch.Tensor:
        return torch.tensor(math.sqrt(self.n / self.m), dtype=torch.float32, device=device)


@register("leverage")
@dataclasses.dataclass(frozen=True)
class LeverageOp(_RowSamplingOp):
    """Leverage-score sampling with replacement: P[row j] = p_j ∝ ℓ_j, the kept row
    scaled by 1/√(m·p_j). The rows are ``categorical(key, log(p + 1e-30), (m,))``,
    drawn on the scores' device, bitwise the reference's for the same p."""

    scales: torch.Tensor = None  # (m,)

    @classmethod
    def build(cls, spec, key, n, *, scores=None, device=None):
        if scores is None:
            raise ValueError(
                "leverage sketches are data-dependent: pass scores= to make_operator "
                "(e.g. sketches.leverage_scores(A)) so the operator is fixed"
            )
        scores = scores.to(torch.float32)
        p = scores / torch.sum(scores)
        rows = prng.categorical(key, prng.xla_log(p + 1e-30), spec.m)
        scales = 1.0 / torch.sqrt(spec.m * p[rows])
        return cls(spec=spec, key=key, n=n, rows=rows, scales=scales)

    def _row_scales(self, device) -> torch.Tensor:
        return self.scales.to(device)


# -------------------------------------------------------------------------- sjlt


@register("sjlt")
@dataclasses.dataclass(frozen=True)
class SJLTOp(SketchOp):
    """Sparse JL: s nonzeros (±1/√s) per input coordinate, counter-derived per row.

    Row parameters come from ``common.sjlt_counter_params``, the same draw the
    SJLT S·A and sketch→Gram kernels make in-core, so kernel and plain paths
    share S.
    """

    k0: int = 0
    k1: int = 0

    @classmethod
    def build(cls, spec, key, n, *, scores=None, device=None):
        k0, k1 = common.key_words(key)
        return cls(spec=spec, key=key, n=n, k0=k0, k1=k1)

    def _params(self, row_idx: torch.Tensor):
        return common.sjlt_counter_params(self.k0, self.k1, row_idx, self.spec.s, self.m)

    def _segment_apply(self, A2: torch.Tensor, row_idx: torch.Tensor) -> torch.Tensor:
        buckets, signs = self._params(row_idx)
        return sref.sjlt_apply(A2, buckets, signs, self.m)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        if self.spec.use_kernel:
            from repro_torch.kernels.sjlt import ops

            return _kernel_apply(lambda X: ops.sjlt_apply(self.key, X, self.m, self.spec.s), A, self.n)
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

    def adjoint(self, Y: torch.Tensor, *, block_rows: int | None = None) -> torch.Tensor:
        def params(j0: int, j1: int):
            return self._params(torch.arange(j0, j1, dtype=torch.int64, device=Y.device))

        return _sjlt_gather(params, Y, self.n, self.m, self.spec.s, block_rows)

    def apply_with_adjoint(self, A: torch.Tensor):
        """With ``spec.use_kernel``, A on the card and shapes that take row 12b
        (``cuda.sjlt_apply_is_long``: gradient compression's CountSketch), the S·A
        kernel also returns the pair list it draws, and the adjoint returned
        gathers from it (:func:`sjlt_adjoint_kept`) instead of drawing the pairs
        again, bitwise the same. The list (4·n·s bytes) lives as long as that
        adjoint. Elsewhere ``(apply(A), adjoint)``: the plain versions keep
        nothing, so the CPU path is the operator's own."""
        from repro_torch.kernels import cuda
        from repro_torch.kernels.sjlt import ops

        k = _to_2d(A, self.n)[0].shape[1]
        if not (self.spec.use_kernel and A.device.type == "cuda"
                and cuda.sjlt_apply_is_long(self.n, self.m, k, self.spec.s)):
            return super().apply_with_adjoint(A)
        kept = []

        def sketch(X):
            SX, pairs = ops.sjlt_apply_keep(self.key, X, self.m, self.spec.s)
            kept.append(pairs)
            return SX

        SA = _kernel_apply(sketch, A, self.n)
        pairs = kept[0]

        def adjoint(Y: torch.Tensor, *, block_rows: int | None = None) -> torch.Tensor:
            return sjlt_adjoint_kept(pairs, Y, self.m, self.spec.s, block_rows=block_rows)

        return SA, adjoint

    @classmethod
    def gram_batched_kernel(cls, spec, keys, A, b):
        from repro_torch.kernels.sjlt import ops

        # The worker key words are the SJLT's own words: no split, as build() does.
        Gf = ops.sjlt_gram_multi(keys, _join_b(A, b), spec.m, spec.s)
        return _split_gram_batched(Gf, A.shape[1], b)

    @classmethod
    def apply_batched_kernel(cls, spec, keys, A):
        from repro_torch.kernels.sjlt import ops

        return _kernel_apply(lambda X: ops.sjlt_apply_multi(keys, X, spec.m, spec.s), A, A.shape[0])


def _sjlt_gather(params, Y: torch.Tensor, n: int, m: int, s: int, block_rows: int | None) -> torch.Tensor:
    """Sᵀ·Y of an SJLT whose columns [j0, j1) have ``params(j0, j1)`` (buckets,
    signs), each (j1 − j0, s). Column j of S holds ±1/√s at its s buckets: a
    gather of Y, signed, summed over s. The columns are taken block_rows at a
    time (default SJLT_ADJOINT_PAIRS pairs; a redraw's int64 threefry
    temporaries take ≈ 100 bytes a pair); each row's sum is its own, so any
    block gives the same bits."""
    Y2, batch = _to_2d(Y, m)
    Yf = Y2.to(torch.float32)
    out = torch.empty((n, Yf.shape[1]), dtype=torch.float32, device=Y.device)
    bs = max(1, min(block_rows or SJLT_ADJOINT_PAIRS // s, n))
    for j0 in range(0, n, bs):
        j1 = min(j0 + bs, n)
        buckets, signs = params(j0, j1)
        out[j0:j1] = torch.sum(Yf[buckets] * signs[..., None], dim=1)
    return out.to(Y.dtype).reshape((n,) + batch)


def sjlt_adjoint_kept(pairs: torch.Tensor, Y: torch.Tensor, m: int, s: int, *,
                      block_rows: int | None = None) -> torch.Tensor:
    """Sᵀ·Y of the SJLT whose pair list an S·A kept: ``pairs`` (n·s,) int32 words
    ``bucket | sign << 31`` in pair order (``kernels/sjlt/ops.sjlt_apply_keep``;
    a set bit 31, a negative word, is −1/√s). The gather of ``SJLTOp.adjoint``
    over those pairs instead of pairs drawn again: the same (n, s) products
    and sums in the same blocks, so bitwise the same. Plain torch, on the
    device of ``pairs`` and Y."""

    def params(j0: int, j1: int):
        words = pairs[j0 * s : j1 * s].reshape(j1 - j0, s)
        signs = (1 - 2 * (words < 0).to(torch.int64)).to(torch.float32) * common.inv_sqrt(s)
        return (words & 0x7FFFFFFF).to(torch.int64), signs

    return _sjlt_gather(params, Y, pairs.shape[0] // s, m, s, block_rows)


# ------------------------------------------------------------------------ hybrid


@register("hybrid")
@dataclasses.dataclass(frozen=True)
class HybridOp(SketchOp):
    """Paper §IV-D: uniform-sample m′ rows without replacement (what a worker can
    afford to read), scale by √(n/m′), then an inner sketch m′ → m (what it can
    afford to compute): S = S_inner · U.

    ``build`` is the reference's: ``k1, k2 = split(key)``, the gumbel top-m′ rows
    from k1, the inner operator (kind ``spec.inner``, with ``spec.s`` and
    ``spec.use_kernel``) from k2 over n = m′ — so an SRHT inner sketch pads to
    next_pow2(m′). With ``spec.use_kernel`` the inner ``apply`` is that kind's
    S·A kernel (the SRHT's fused forward), and a Gaussian inner ``adjoint`` the
    Gaussian adjoint kernel; ``apply_with_adjoint`` passes the inner operator's
    (a Gaussian keeps its S) through the gather and the scatter.
    """

    rows: torch.Tensor = None  # (m_prime,)
    inner: SketchOp = None

    @classmethod
    def build(cls, spec, key, n, *, scores=None, device=None):
        halves = prng.split(key)
        rows = prng.gumbel_top_k(halves[0], n, spec.m_prime, device=device)
        inner_spec = sk.SketchSpec(spec.inner, spec.m, s=spec.s, use_kernel=spec.use_kernel)
        inner = make_operator(inner_spec, halves[1], spec.m_prime, device=device)
        return cls(spec=spec, key=key, n=n, rows=rows, inner=inner)

    @property
    def _scale(self) -> float:
        return math.sqrt(self.n / self.spec.m_prime)

    def _sample(self, A: torch.Tensor) -> torch.Tensor:
        return A[self.rows.to(A.device)] * torch.tensor(self._scale, dtype=A.dtype, device=A.device)

    def apply(self, A: torch.Tensor) -> torch.Tensor:
        return self.inner.apply(self._sample(A))

    def apply_with_adjoint(self, A: torch.Tensor):
        SA, inner_adjoint = self.inner.apply_with_adjoint(self._sample(A))
        return SA, lambda Y, *, block_rows=DEFAULT_BLOCK_ROWS: self._adjoint_via(inner_adjoint, Y)

    def _stream_pieces(self, k: int, device):
        init = torch.zeros((self.spec.m_prime, k), dtype=torch.float32, device=device)
        scale = torch.tensor(self._scale, dtype=torch.float32, device=device)
        return init, _gather_rows_reducer(self.rows), lambda acc: self.inner.apply(acc * scale)

    def gram_blocked(self, A, b=None, *, block_rows: int = DEFAULT_BLOCK_ROWS):
        scale = torch.tensor(self._scale, dtype=torch.float32, device=A.device)
        SAb = self.inner.apply((_gather_joint(A, b, self.rows) * scale).contiguous())
        return _gram_of(SAb, A.shape[1], b)

    def adjoint(self, Y: torch.Tensor, *, block_rows: int = DEFAULT_BLOCK_ROWS) -> torch.Tensor:
        return self._adjoint_via(self.inner.adjoint, Y)

    def _adjoint_via(self, inner_adjoint, Y: torch.Tensor) -> torch.Tensor:
        # Sᵀ = Uᵀ·S_innerᵀ: the inner adjoint into m′ rows, scattered to the distinct rows.
        Y2, batch = _to_2d(Y, self.m)
        z = inner_adjoint(Y2)
        out = _scatter_rows(self.rows, z, self.n) * torch.tensor(self._scale, dtype=z.dtype, device=z.device)
        return out.to(Y.dtype).reshape((self.n,) + batch)


# --------------------------------------------------------------- functional API


def _scores_for(spec: sk.SketchSpec, A: torch.Tensor, scores) -> Optional[torch.Tensor]:
    """The leverage scores a ``leverage`` sketch of A needs (computed from A when
    not given); ``scores`` as passed for every other kind."""
    if spec.kind == "leverage" and scores is None:
        return sk.leverage_scores(A.reshape(A.shape[0], -1).to(torch.float32))
    return scores


def apply(spec: sk.SketchSpec, key: torch.Tensor, A: torch.Tensor, *, scores=None) -> torch.Tensor:
    """``S @ A`` — registry-dispatched."""
    scores = _scores_for(spec, A, scores)
    return make_operator(spec, key, A.shape[0], scores=scores, device=A.device).apply(A)


def apply_blocked(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    scores=None,
) -> torch.Tensor:
    """``S @ A`` streamed over row tiles of A."""
    scores = _scores_for(spec, A, scores)
    op = make_operator(spec, key, A.shape[0], scores=scores, device=A.device)
    return op.apply_blocked(A, block_rows=block_rows)


def gram_blocked(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    scores=None,
):
    """Fused single-pass ``(G, c) = ((SA)ᵀ(SA), (SA)ᵀ(Sb))`` — registry-dispatched.
    A leverage sketch takes its scores from A (not from ``[A | b]``), as the
    reference does."""
    scores = _scores_for(spec, A, scores)
    op = make_operator(spec, key, A.shape[0], scores=scores, device=A.device)
    return op.gram_blocked(A, b, block_rows=block_rows)


def _kernel_tile_sketch(spec: sk.SketchSpec, key: torch.Tensor):
    """``f(X, row0) = S[:, row0 : row0 + len(X)]·X`` by the kind's S·A kernel with
    ``spec.use_kernel`` and a Gaussian, Rademacher or SJLT kind (its plain
    version on a CPU tensor), else None."""
    if not spec.use_kernel:
        return None
    if spec.kind == "gaussian":
        from repro_torch.kernels.gaussian import ops

        return lambda X, row0: ops.gaussian_sketch(key, X, spec.m, row0=row0)
    if spec.kind == "rademacher":
        from repro_torch.kernels.rademacher import ops

        return lambda X, row0: ops.rademacher_sketch(key, X, spec.m, row0=row0)
    if spec.kind == "sjlt":
        from repro_torch.kernels.sjlt import ops

        return lambda X, row0: ops.sjlt_apply(key, X, spec.m, spec.s, row0=row0)
    return None


def gram_blocked_host(
    spec: sk.SketchSpec,
    key: torch.Tensor,
    A,
    b=None,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    scores=None,
    device=None,
):
    """Out-of-core :func:`gram_blocked` for A on the HOST (a numpy array or an
    ``np.memmap``, b likewise or None): n may exceed the card's memory.

    Row tiles of ``block_rows`` rows of ``[A | b]`` (the last one shorter when
    block_rows does not divide n; the reference zero-pads it, and zero rows add
    nothing) are copied into pinned host memory, two buffers in turn, and from
    there to the card on a stream of their own: the copy of tile i+1 runs while
    tile i is reduced, the two ordered by events. With ``spec.use_kernel`` a
    Gaussian, Rademacher or SJLT tile goes through the kind's S·A kernel at its
    row offset (``S[:, j0 : j0 + len]·tile``; a Rademacher tile must start at a
    whole sign word, so ``block_rows`` is then a multiple of 32), and the m×k
    partial sums are added into one accumulator on the card in tile order, so
    a rerun is bitwise the same. Every other kind and ``use_kernel=False``
    reduce each tile with the kind's plain stream pieces, as the reference does
    for every kind: the SRHT's closed-form column tiles (O(n·m) work; its FWHT
    kernel needs all n_pad rows at once, which streaming does not give it), a
    gather for the sampling kinds, the hybrid's gather then its inner sketch.
    The Gram of the m×k result is one full-float32 product. Peak card memory is
    O(block_rows·k + m·k).

    ``device``: ``None`` means CUDA (raises when absent); pass ``"cpu"`` for the
    CPU, where the tiles are used in place (no pinned buffers, no streams).
    """
    import numpy as np

    from repro_torch.utils.device import resolve_device

    if A.ndim != 2:
        raise ValueError(f"gram_blocked_host expects A of shape (n, d), got {tuple(A.shape)}")
    dev = resolve_device(device)
    n, d = A.shape
    bm = None if b is None else (b if b.ndim == 2 else np.asarray(b)[:, None])
    k = d + (0 if bm is None else bm.shape[1])
    op = make_operator(spec, key, n, scores=scores, device=dev)
    tile_sketch = _kernel_tile_sketch(spec, key)
    bs = max(1, min(block_rows, n))
    if tile_sketch is not None and spec.kind == "rademacher" and dev.type == "cuda" and bs % 32 and bs < n:
        raise ValueError(f"a Rademacher kernel tile starts at a whole sign word: block_rows must be a multiple "
                         f"of 32, got {block_rows}")
    if tile_sketch is None:
        acc, reducer, finish = op._stream_pieces(k, dev)
    else:
        acc, finish = None, lambda a: a

    def host_rows(j0: int, rows: int, into: torch.Tensor) -> torch.Tensor:
        view = into.numpy()  # the (pinned) host buffer itself: one copy from A, converted on the way
        view[:, :d] = A[j0 : j0 + rows]
        if bm is not None:
            view[:, d:] = bm[j0 : j0 + rows]
        return into

    def reduce(acc, j0: int, tile: torch.Tensor):
        if tile_sketch is None:
            return reducer(acc, j0, tile)
        part = tile_sketch(tile, j0)
        return part if acc is None else acc.add_(part)

    with common.full_fp32_matmul():
        if dev.type != "cuda":
            for j0 in range(0, n, bs):
                rows = min(bs, n - j0)
                acc = reduce(acc, j0, host_rows(j0, rows, torch.empty((rows, k), dtype=torch.float32)))
        else:
            pinned = [torch.empty((bs, k), dtype=torch.float32, pin_memory=True) for _ in range(2)]
            bufs = [torch.empty((bs, k), dtype=torch.float32, device=dev) for _ in range(2)]
            main, side = torch.cuda.current_stream(dev), torch.cuda.Stream(device=dev)
            copied = [torch.cuda.Event() for _ in range(2)]  # a tile reached its card buffer
            freed = [torch.cuda.Event() for _ in range(2)]   # a card buffer's tile was reduced

            def stage(i: int) -> None:
                slot, j0 = i % 2, i * bs
                rows = min(bs, n - j0)
                copied[slot].synchronize()  # the copy out of this pinned buffer two tiles ago is done
                host_rows(j0, rows, pinned[slot][:rows])
                with torch.cuda.stream(side):
                    side.wait_event(freed[slot])
                    bufs[slot][:rows].copy_(pinned[slot][:rows], non_blocking=True)
                    copied[slot].record(side)

            nb = -(-n // bs)
            stage(0)
            for i in range(nb):
                slot, j0 = i % 2, i * bs
                main.wait_event(copied[slot])
                acc = reduce(acc, j0, bufs[slot][: min(bs, n - j0)])
                freed[slot].record(main)
                if i + 1 < nb:
                    stage(i + 1)  # host and copy work for tile i+1 while the card reduces tile i
        SAb = finish(acc).to(torch.float32)
        return _split_gram(SAb.T @ SAb, d, b)


def gram_batched(
    spec: sk.SketchSpec,
    keys: torch.Tensor,
    A: torch.Tensor,
    b: Optional[torch.Tensor] = None,
    *,
    scores=None,
    block_rows: int = DEFAULT_BLOCK_ROWS,
):
    """All q workers' fused Grams ``(Gs, cs)``, shapes (q, d, d) and (q, d[, k]);
    ``cs`` is None when b is. ``keys``: (q, 2) words (``prng.worker_keys``).

    With ``spec.use_kernel`` and a projection kind this is the multi-worker
    kernel, launched for all q workers at once (in chunks of
    ``kernels.cuda.worker_chunk`` workers on the card), whose worker slices are
    bitwise equal to the per-key kernel path; otherwise a loop of per-key Grams.
    Leverage scores are computed once, from A, and shared by the q workers.
    """
    scores = _scores_for(spec, A, scores)
    if spec.use_kernel:
        fused = _operator_class(spec).gram_batched_kernel(spec, keys, A, b)
        if fused is not NotImplemented:
            return fused
    n = A.shape[0]
    outs = [
        make_operator(spec, k, n, scores=scores, device=A.device).gram_blocked(A, b, block_rows=block_rows)
        for k in keys
    ]
    Gs = torch.stack([G for G, _ in outs])
    return Gs, (None if b is None else torch.stack([c for _, c in outs]))


def apply_batched(spec: sk.SketchSpec, keys: torch.Tensor, A: torch.Tensor, *, scores=None) -> torch.Tensor:
    """All q workers' sketches ``(S_k A)_k`` as a (q, m, ...) stack.

    With ``spec.use_kernel`` and a dense or SJLT kind this is the multi-worker
    S·A kernel, launched for all q workers at once (in chunks of
    ``kernels.cuda.worker_chunk`` on the card), its slices bitwise equal to
    per-key applies; otherwise a loop of per-key applies. Leverage scores are
    computed once, from A, and shared.
    """
    scores = _scores_for(spec, A, scores)
    if spec.use_kernel:
        fused = _operator_class(spec).apply_batched_kernel(spec, keys, A)
        if fused is not NotImplemented:
            return fused
    n = A.shape[0]
    return torch.stack([make_operator(spec, k, n, scores=scores, device=A.device).apply(A) for k in keys])


def sketch_data_batched(spec: sk.SketchSpec, keys: torch.Tensor, A: torch.Tensor, b: torch.Tensor):
    """Batched Algorithm-1 master step: ``(S_k A, S_k b)`` for every worker key,
    sketching ``[A | b]`` jointly so each worker's pair shares its S (a leverage
    sketch takes its scores from ``[A | b]``, as the reference does)."""
    bm = b if b.ndim == 2 else b[:, None]
    d = A.shape[1]
    SAb = apply_batched(spec, keys, torch.cat([A, bm.to(A.dtype)], dim=1))
    Sb = SAb[..., d:]
    return SAb[..., :d], (Sb if b.ndim == 2 else Sb[..., 0])
