"""Row 12b, the SJLT S·A of few, long columns, on the CPU: its plan
(``kernels/cuda.py`` ``plan_sjlt_long``), the plain model of its partitioned
entries (``sjlt.ref.long_partition``) and of its pair list
(``sjlt.ref.long_pairs``), and the CountSketch's adjoint over a kept pair list
(``core.operators.sjlt_adjoint_kept``). No card is needed.

The premises: the pair list is the JAX reference's pairs, bit for bit; the
entries of every round and column group, summed in the kernel's fixed point
(``_sjlt_fixed_point.fixed_point_sum``), are bitwise ``sketch_fixed_point``,
the arithmetic the card is held to; the gather over a kept list is bitwise the
gather over pairs drawn again, and within 1e-6 of the reference's adjoint.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sjlt_fixed_point as fixed
from repro.core import operators as jops, sketches as jsk
from repro.kernels import common as jcommon
from repro_torch.core import gradcomp, operators, sketches
from repro_torch.kernels import common, cuda as tcuda
from repro_torch.kernels.sjlt import ops as sops, ref as sref
from repro_torch.utils import prng

GRAD_N = 2**20 + 2**16  # gradcomp_bench's vector


@pytest.mark.parametrize("m", [1, 64, 11_142, 2**30])
@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("d", [1, 8])
def test_long_plan_covers_m_fits_and_fills_the_card(d, s, m):
    plan = tcuda.plan_sjlt_long(GRAD_N, m, d, s)
    assert plan.pairs == GRAD_N * s and plan.cols == d
    # partitions cover [0, m) with no gap; with two levels, groups cover the partitions
    assert (plan.parts - 1) * plan.bucket_tile < m <= plan.parts * plan.bucket_tile
    assert plan.bucket_tile < 2**16  # 16-bit entry buckets
    if plan.group_parts:
        assert (plan.groups - 1) * plan.group_parts < plan.parts <= plan.groups * plan.group_parts
        assert plan.sub >= 1 and plan.groups * plan.sub >= 132
    assert plan.pass_width <= tcuda.SJLT_LONG_MAX_BINS
    # chunks of whole tiles cover the pairs, none empty
    assert plan.chunk_pairs % tcuda.SJLT_LONG_TILE == 0
    assert (plan.chunks - 1) * plan.chunk_pairs < plan.pairs <= plan.chunks * plan.chunk_pairs
    assert max(plan.acc_smem, plan.scatter_smem) <= tcuda.SJLT_SMEM
    assert 2 * (plan.acc_smem + 1024) <= 233_472  # two accumulate blocks an SM
    assert plan.parts >= min(m, 132)  # accumulate blocks: a bucket each at a tiny m
    assert plan.scratch_bytes % 16 == 0
    tcuda.plan_sjlt_long.cache_clear()
    assert tcuda.plan_sjlt_long(GRAD_N, m, d, s) == plan


def test_long_plan_refuses_what_the_entry_cannot_take():
    for bad in ((0, 5, 1, 1), (10, 0, 1, 1), (10, 2**31, 1, 1), (2**31, 5, 1, 2), (10, 5, 0, 1)):
        with pytest.raises(ValueError, match="long-column"):
            tcuda.plan_sjlt_long(*bad)


def _x(n, d, seed):
    """N(0, 1) values times 2^k, k in [-10, 10] a row: buckets mix exponents."""
    rs = np.random.default_rng(seed)
    x = rs.standard_normal((n, d)) * np.exp2(rs.integers(-10, 11, (n, 1)))
    return torch.from_numpy(x.astype(np.float32))


# (n, m, d, s, bucket_tile): the plan's own, and smaller partitions so a small
# case takes many; d past one column group.
PARTITION_CASES = [(4096, 64, 1, 1, None), (30_001, 997, 3, 4, None), (20_000, 5000, 1, 1, 64),
                   (7000, 3001, 11, 2, 100), (65_536, 11_142, 1, 1, 1000)]


def _plan(n, m, d, s, bucket_tile):
    plan = tcuda.plan_sjlt_long(n, m, d, s)
    if bucket_tile is None:
        return plan
    return dataclasses.replace(plan, bucket_tile=bucket_tile, parts=-(-m // bucket_tile))


@pytest.mark.parametrize("n,m,d,s,bucket_tile", PARTITION_CASES)
def test_partitioned_entries_sum_to_the_fixed_point_sketch(n, m, d, s, bucket_tile):
    """Every column group's entries, in partition order, summed in the kernel's
    fixed point, are bitwise ``sketch_fixed_point``; each partition's entries
    lie in its buckets and fill base's segment."""
    plan = _plan(n, m, d, s, bucket_tile)
    key = prng.prng_key(n + m)
    X = _x(n, d, m)
    pairs = sref.long_pairs(key, n, m, s)
    got = torch.zeros((m, d), dtype=torch.float32)
    for c0 in range(0, d, plan.cols):
        part = sref.long_partition(pairs, X, s, plan, c0=c0)
        cols = part["evals"].shape[1]
        assert part["ebucket"].min() >= 0 and part["ebucket"].max() < plan.bucket_tile
        assert part["base"][-1] == n * s
        lengths = part["base"].diff()
        b = torch.repeat_interleave(torch.arange(plan.parts), lengths) * plan.bucket_tile + part["ebucket"]
        got[:, c0 : c0 + cols] = fixed.fixed_point_sum(b, part["evals"], m, common.inv_sqrt(s))
    assert torch.equal(got, fixed.sketch_fixed_point(key, X, m, s))


def test_partition_keeps_pair_order_within_a_partition():
    n, m, s = 5000, 300, 2
    plan = _plan(n, m, 1, s, 32)
    X = torch.arange(n, dtype=torch.float32)[:, None] + 1  # the value names its row
    pairs = sref.long_pairs(prng.prng_key(3), n, m, s)
    part = sref.long_partition(pairs, X, s, plan)
    rows = part["evals"][:, 0].abs() - 1
    for p in range(plan.parts):
        seg = rows[part["base"][p] : part["base"][p + 1]]
        assert torch.all(seg.diff() >= 0)  # pair order: rows ascend (t of one row next to each other)
    assert part["base"][4] == int(((pairs.to(torch.int64) & 0x7FFFFFFF) < 4 * 32).sum())


@pytest.mark.parametrize("s", [1, 4])
def test_long_pairs_are_the_references_pairs(s):
    n, m, row0 = 3000, 777, 12_345
    key = prng.prng_key(7)
    pairs = sref.long_pairs(key, n, m, s, row0=row0).to(torch.int64)
    k0, k1 = common.key_words(key)
    jb, js = jcommon.sjlt_counter_params(jnp.uint32(k0), jnp.uint32(k1), jnp.arange(row0, row0 + n), s, m)
    assert torch.equal(pairs & 0x7FFFFFFF, torch.from_numpy(np.asarray(jb, np.int64)).reshape(-1))
    assert torch.equal(pairs < 0, torch.from_numpy(np.asarray(js) < 0).reshape(-1))
    assert bool((pairs < 0).any()) and bool((pairs >= 0).any())


@pytest.mark.parametrize("block_rows", [None, 333])
@pytest.mark.parametrize("row0", [0, 4096])
@pytest.mark.parametrize("s", [1, 4])
def test_kept_gather_is_the_redraw_adjoint(s, row0, block_rows):
    """Over a kept list (sign-bit-set words among them), bitwise the SJLT
    operator's adjoint of the same columns (at row0 > 0: the rows of a taller
    operator's adjoint), and within 1e-6 of the reference's adjoint."""
    n, m = 2000, 500
    key = prng.prng_key(11)
    Y = torch.from_numpy(np.random.default_rng(s).standard_normal((m, 3)).astype(np.float32))
    pairs = sref.long_pairs(key, n, m, s, row0=row0)
    assert bool((pairs < 0).any())
    got = operators.sjlt_adjoint_kept(pairs, Y, m, s, block_rows=block_rows)
    op = operators.make_operator(sketches.SketchSpec("sjlt", m, s=s), key, row0 + n)
    assert torch.equal(got, op.adjoint(Y, block_rows=block_rows)[row0:])
    jop = jops.make_operator(jsk.SketchSpec("sjlt", m, s=s), jax.random.PRNGKey(11), row0 + n)
    want = np.asarray(jop.adjoint(jnp.asarray(Y.numpy())))[row0:]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_apply_with_adjoint_without_the_kernel_is_apply_and_adjoint():
    n, m, s = 3000, 200, 4
    key = prng.prng_key(2)
    A = _x(n, 2, 5)
    Y = torch.from_numpy(np.random.default_rng(6).standard_normal((m, 2)).astype(np.float32))
    op = operators.make_operator(sketches.SketchSpec("sjlt", m, s=s), key, n)
    SA, adjoint = op.apply_with_adjoint(A)
    assert torch.equal(SA, op.apply(A)) and torch.equal(adjoint(Y), op.adjoint(Y))


def test_keep_wrapper_on_the_cpu_is_its_plain_version():
    """``ops.sjlt_apply_keep`` on a CPU tensor (a row-12b shape): ``sjlt_apply``'s
    S·A and the plain pair list; the gather over that list, with no pair drawn
    again, is bitwise the operator's adjoint. The operator itself keeps nothing
    on the CPU: its ``apply_with_adjoint`` hands out its own adjoint."""
    n, m, s = 4000, 40_000, 1
    key = prng.prng_key(4)
    A = _x(n, 1, 8)
    assert tcuda.sjlt_apply_is_long(n, m, 1, s)
    SA, pairs = sops.sjlt_apply_keep(key, A, m, s)
    assert torch.equal(SA, sops.sjlt_apply(key, A, m, s))
    assert torch.equal(pairs, sref.long_pairs(key, n, m, s))
    op = operators.make_operator(sketches.SketchSpec("sjlt", m, s=s, use_kernel=True), key, n)
    want = op.adjoint(SA)
    draws = operators.SJLTOp._params
    try:
        operators.SJLTOp._params = lambda *a, **k: pytest.fail("the kept gather drew pairs")
        got = operators.sjlt_adjoint_kept(pairs, SA, m, s)
    finally:
        operators.SJLTOp._params = draws
    assert torch.equal(got, want)
    assert op.apply_with_adjoint(A)[1].__func__ is operators.SJLTOp.adjoint


def test_compress_hands_decompress_the_operators_adjoint_on_the_cpu():
    """On the CPU (no kernel) the CountSketch's ctx is the operator's own
    adjoint, and the round trip is unchanged: bitwise apply, then adjoint."""
    g = {"w": _x(4096, 1, 9)[:, 0]}
    key = prng.prng_key(5)
    cfg = gradcomp.GradCompressionConfig(enabled=True, ratio=0.1)
    payload, ctx = gradcomp.compress(cfg, key, g)
    op = operators.make_operator(sketches.SketchSpec("sjlt", 410, s=1), key, 4096)
    assert ctx[0].__func__ is operators.SJLTOp.adjoint  # the redraw, as before
    assert torch.equal(payload, op.apply(g["w"]))
    assert torch.equal(gradcomp.decompress(cfg, payload, ctx)["w"], op.adjoint(payload))
