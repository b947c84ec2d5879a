"""Sketched gradient compression in the port against the JAX reference (CPU).

* ``utils.tree``: the leaf order (sorted dict keys, depth first) and the flat
  float32 vector are the reference's, a bf16 leaf included; the tree helpers agree.
* ``compress`` / ``decompress`` / ``compression_error`` for CountSketch and the
  Gaussian: the payload and the reconstruction within 1e-6 of the reference's,
  relative (‖Δ‖₂/‖want‖₂: the CountSketch's integer streams are bitwise; the
  Gaussian's entries differ from the reference's by ulps, and Sᵀ(Sg) adds m of
  them per coordinate);
  ``compressed_psum_mean`` without a group (one worker) in both modes and with
  compression off against the reference's parts (its mean over one device is
  the worker's own; fresh_sketch folds in worker 0); the straggler-masked mean.
* The reference's own checks (``tests/test_gradcomp.py``) repeated on the port.
* The SJLT adjoint drawn in blocks is bitwise the adjoint drawn at once.
* Row 12b's arithmetic (``_sjlt_fixed_point.sketch_fixed_point``, the long-column
  entry's fixed-point sums) against the plain SJLT S·A, and the rule that
  routes an S·A to that entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _sjlt_fixed_point as fixed
from repro.core import gradcomp as jgc, operators as jops, sketches as jsk
from repro.utils import tree as jtree
from repro_torch.core import gradcomp as tgc, operators as tops, sketches as tsk
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels.sjlt import ref as sref
from repro_torch.train import sketch_dp as tdp
from repro_torch.utils import prng as tprng, tree as ttree

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

TOL = 1e-6
KINDS = ["countsketch", "gaussian"]


def _grads(seed, D=2048):
    rs = np.random.default_rng(seed)
    return {"w": rs.standard_normal(D).astype(np.float32), "b": rs.standard_normal((D // 8, 8)).astype(np.float32)}


def _both(g):
    return jax.tree_util.tree_map(jnp.asarray, g), {k: torch.from_numpy(v) for k, v in g.items()}


def _keys(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _nested(rs):
    return {"z": {"k": rs.standard_normal((3, 4)).astype(np.float32),
                  "a": [rs.standard_normal(5).astype(np.float32), (rs.standard_normal(2).astype(np.float32),)]},
            "emb": rs.standard_normal((6, 2)).astype(np.float32), "b": rs.standard_normal(7).astype(np.float32)}


def test_tree_vector_is_the_references_with_a_bf16_leaf():
    rs = np.random.default_rng(0)
    tree = _nested(rs)
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = jax.tree_util.tree_map(torch.from_numpy, tree)
    jt["z"]["k"] = jt["z"]["k"].astype(jnp.bfloat16)
    tt["z"]["k"] = tt["z"]["k"].to(torch.bfloat16)
    jvec, jvz = jtree.tree_flatten_to_vector(jt)
    tvec, tvz = ttree.tree_flatten_to_vector(tt)
    assert np.array_equal(np.asarray(jvec), tvec.numpy())
    assert [tuple(x.shape) for x in jax.tree_util.tree_leaves(jt)] == [tuple(x.shape) for x in ttree.tree_leaves(tt)]
    back = tvz.unflatten(tvec * 2)
    jback = jvz.unflatten(jvec * 2)
    assert back["z"]["k"].dtype == torch.bfloat16 and isinstance(back["z"]["a"][1], tuple)
    for a, b in zip(jax.tree_util.tree_leaves(jback), ttree.tree_leaves(back)):
        assert np.array_equal(np.asarray(a.astype(jnp.float32)), b.to(torch.float32).numpy())
    assert tvz.total == jvz.total


def test_tree_helpers_agree_with_the_reference():
    rs = np.random.default_rng(1)
    tree = _nested(rs)
    jt, tt = jax.tree_util.tree_map(jnp.asarray, tree), jax.tree_util.tree_map(torch.from_numpy, tree)
    assert ttree.tree_size(tt) == jtree.tree_size(jt)
    assert ttree.tree_bytes(tt) == jtree.tree_bytes(jt)
    assert abs(float(ttree.tree_global_norm(tt)) - float(jtree.tree_global_norm(jt))) <= 1e-6 * float(
        jtree.tree_global_norm(jt))
    for got, want in ((ttree.tree_add(tt, tt), jtree.tree_add(jt, jt)), (ttree.tree_scale(tt, 3.0), jtree.tree_scale(jt, 3.0)),
                      (ttree.tree_zeros_like(tt), jtree.tree_zeros_like(jt))):
        for a, b in zip(ttree.tree_leaves(got), jax.tree_util.tree_leaves(want)):
            assert np.array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="structure"):
        ttree.tree_map(torch.add, tt, {"b": tt["b"]})


@pytest.mark.parametrize("ratio", [0.02, 0.1, 0.25])
@pytest.mark.parametrize("kind", KINDS)
def test_compress_and_decompress_match_the_reference(kind, ratio):
    jg, tg = _both(_grads(2))
    jkey, tkey = _keys(3)
    jcfg = jgc.GradCompressionConfig(enabled=True, ratio=ratio, kind=kind)
    tcfg = tgc.GradCompressionConfig(enabled=True, ratio=ratio, kind=kind)
    jp, jctx = jgc.compress(jcfg, jkey, jg)
    tp, tctx = tgc.compress(tcfg, tkey, tg)
    assert tuple(tp.shape) == tuple(jp.shape)
    assert _rel(tp.numpy(), jp) <= TOL
    jrec, trec = jgc.decompress(jcfg, jp, jctx), tgc.decompress(tcfg, tp, tctx)
    for leaf in ("w", "b"):
        assert _rel(trec[leaf].numpy(), jrec[leaf]) <= TOL
    err_j, err_t = float(jgc.compression_error(jcfg, jkey, jg)), float(tgc.compression_error(tcfg, tkey, tg))
    assert abs(err_t - err_j) <= 1e-5 * err_j


@pytest.mark.parametrize("mode", ["same_sketch", "fresh_sketch", "off"])
@pytest.mark.parametrize("kind", KINDS)
def test_compressed_mean_of_one_worker_is_the_references(kind, mode):
    """Over one worker the reference's mean is its own reconstruction: S from
    the key (same_sketch) or from fold_in(key, 0) (fresh_sketch), the gradient
    itself with compression off."""
    jg, tg = _both(_grads(4))
    jkey, tkey = _keys(5)
    enabled = mode != "off"
    kw = dict(enabled=enabled, ratio=0.1, kind=kind, mode="same_sketch" if mode == "off" else mode)
    jcfg, tcfg = jgc.GradCompressionConfig(**kw), tgc.GradCompressionConfig(**kw)
    got = tgc.compressed_psum_mean(tcfg, tkey, tg, None)
    if not enabled:
        want = jg
    else:
        k = jax.random.fold_in(jkey, 0) if mode == "fresh_sketch" else jkey
        want = jgc.decompress(jcfg, *jgc.compress(jcfg, k, jg))
    for leaf in ("w", "b"):
        assert _rel(got[leaf].numpy(), want[leaf]) <= TOL


@pytest.mark.parametrize("mask", [1.0, 0.0])
@pytest.mark.parametrize("enabled", [True, False])
def test_masked_compressed_mean_of_one_worker(enabled, mask):
    """One worker: its reconstruction (or gradient) times its mask, over max(mask, 1)."""
    jg, tg = _both(_grads(6))
    jkey, tkey = _keys(7)
    jcfg = jgc.GradCompressionConfig(enabled=enabled, ratio=0.1)
    tcfg = tgc.GradCompressionConfig(enabled=enabled, ratio=0.1)
    got = tdp.masked_compressed_mean(tcfg, tkey, tg, mask)
    want = jgc.decompress(jcfg, *jgc.compress(jcfg, jkey, jg)) if enabled else jg
    for leaf in ("w", "b"):
        np.testing.assert_allclose(got[leaf].numpy(), mask * np.asarray(want[leaf]), rtol=0,
                                   atol=TOL * float(np.abs(want[leaf]).max()))


def test_masked_mean_of_a_bf16_leaf_promotes_as_the_reference():
    tg = {"w": torch.ones(16, dtype=torch.bfloat16)}
    out = tdp.masked_compressed_mean(tgc.GradCompressionConfig(enabled=False), tprng.prng_key(0), tg, 1.0)
    assert out["w"].dtype == torch.float32


def test_masked_mean_reduces_the_mask_on_the_gradients_device(monkeypatch):
    """A scalar mask goes into the ``all_reduce`` on the gradients' device, not
    the CPU (NCCL reduces only CUDA tensors): every tensor the uncompressed mean
    hands to ``psum`` lies where the leaves lie (here the meta device)."""
    from repro_torch.core import averaging as tavg

    seen = []
    monkeypatch.setattr(tavg, "psum", lambda x, group=None: seen.append(x.device) or x)
    tg = {"w": torch.ones(16, device="meta"), "b": torch.ones(4, device="meta")}
    out = tdp.masked_compressed_mean(tgc.GradCompressionConfig(enabled=False), tprng.prng_key(0), tg, 1.0)
    assert seen and all(dev.type == "meta" for dev in seen)
    assert all(v.device.type == "meta" for v in out.values())


def test_config_takes_no_knob_it_would_ignore():
    """The reference's ``min_size`` is read by nothing (every leaf is
    flattened into the one sketched vector): the port has no such field."""
    assert "min_size" not in {f.name for f in dataclasses.fields(tgc.GradCompressionConfig)}
    with pytest.raises(TypeError):
        tgc.GradCompressionConfig(enabled=True, min_size=4096)


# ------------------------------------------------ the reference's own checks, on the port


def _tree(seed, D=4096):
    rs = np.random.default_rng(seed)
    return {"a": torch.from_numpy(rs.standard_normal(D).astype(np.float32)),
            "b": torch.from_numpy(rs.standard_normal((D // 8, 8)).astype(np.float32))}


def test_roundtrip_shapes_and_dtypes():
    g = _tree(0)
    g["b"] = g["b"].to(torch.bfloat16)
    cfg = tgc.GradCompressionConfig(enabled=True, ratio=0.25, kind="countsketch")
    payload, ctx = tgc.compress(cfg, tprng.prng_key(1), g)
    rec = tgc.decompress(cfg, payload, ctx)
    assert sorted(rec) == sorted(g)
    for k in g:
        assert rec[k].shape == g[k].shape and rec[k].dtype == g[k].dtype


def test_countsketch_unbiased():
    """E[Sᵀ S g] = g: the mean of 400 independent sketches of one gradient."""
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(512).astype(np.float32))}
    cfg = tgc.GradCompressionConfig(enabled=True, ratio=0.25, kind="countsketch")
    recs = [tgc.decompress(cfg, *tgc.compress(cfg, tprng.fold_in(tprng.prng_key(1), i), g))["w"] for i in range(400)]
    mean = torch.stack(recs).mean(0)
    assert float(torch.linalg.norm(mean - g["w"]) / torch.linalg.norm(g["w"])) < 0.2


def test_error_decreases_with_ratio():
    g = _tree(0)
    errs = [float(tgc.compression_error(tgc.GradCompressionConfig(enabled=True, ratio=r), tprng.prng_key(2), g))
            for r in (0.02, 0.1, 0.5)]
    assert errs[0] > errs[1] > errs[2]


def test_gaussian_projection_roundtrip():
    g = {"w": torch.from_numpy(np.random.default_rng(0).standard_normal(256).astype(np.float32))}
    cfg = tgc.GradCompressionConfig(enabled=True, ratio=0.5, kind="gaussian")
    assert float(tgc.compression_error(cfg, tprng.prng_key(1), g)) < 1.5


def test_unknown_kind_raises():
    with pytest.raises(ValueError):
        tgc.compress(tgc.GradCompressionConfig(enabled=True, kind="srht"), tprng.prng_key(0), _tree(0))


# ---------------------------------------------------- the SJLT adjoint in blocks


@pytest.mark.parametrize("block_rows", [1, 7, 300, 1 << 20])
@pytest.mark.parametrize("s", [1, 4])
def test_sjlt_adjoint_in_blocks_is_bitwise_the_whole_draw(block_rows, s):
    n, m = 1001, 96
    op = tops.make_operator(tsk.SketchSpec("sjlt", m, s=s), tprng.prng_key(8), n)
    Y = torch.from_numpy(np.random.default_rng(9).standard_normal((m, 3)).astype(np.float32))
    buckets, signs = op._params(torch.arange(n))
    whole = torch.sum(Y[buckets] * signs[..., None], dim=1)
    assert torch.equal(op.adjoint(Y, block_rows=block_rows), whole)
    assert torch.equal(op.adjoint(Y), whole)
    jop = jops.make_operator(jsk.SketchSpec("sjlt", m, s=s), jax.random.PRNGKey(8), n)
    assert _rel(op.adjoint(Y[:, 0]).numpy(), jop.adjoint(jnp.asarray(Y[:, 0].numpy()))) <= TOL


# -------------------------------------------- row 12b's arithmetic and its routing


@pytest.mark.parametrize("n,m,d,s,row0", [(4096, 64, 1, 1, 0), (5000, 777, 3, 4, 0), (3000, 40_000, 1, 1, 17),
                                          (1000, 50, 8, 20, 4096), (20_000, 3, 2, 1, 0)])
def test_long_column_fixed_point_matches_the_plain_sketch(n, m, d, s, row0):
    """Per bucket, max |Δ| / Σ|terms| ≤ 1e-6 (the fixed-point sums are exact to
    L²·2⁻⁶¹ of the largest term, then rounded once; the plain version sums in
    float64 and rounds once), on data whose scale spans 2⁻¹⁴ to 2¹⁴."""
    rs = np.random.default_rng(n + m)
    A = torch.from_numpy((rs.standard_normal((n, d)) * np.exp2(rs.integers(-14, 15, (n, 1)))).astype(np.float32))
    key = tprng.prng_key(m)
    want = sref.sketch(key, A, m, s, row0=row0)
    got = fixed.sketch_fixed_point(key, A, m, s, row0=row0)
    k0, k1 = tprng.prng_key(m).tolist()
    buckets, _ = sref.common.sjlt_counter_params(k0, k1, row0 + torch.arange(n), s, m)
    mass = torch.zeros((m, d), dtype=torch.float64).index_add_(
        0, buckets.reshape(-1), A.double().abs().repeat_interleave(s, dim=0) / s**0.5)
    assert float(((got.double() - want.double()).abs() / mass.clamp_min(1e-300)).max()) <= 1e-6


def test_long_column_fixed_point_keeps_infinities_and_nans():
    A = torch.from_numpy(np.random.default_rng(3).standard_normal((600, 2)).astype(np.float32))
    A[5, 0], A[9, 1], A[11, 1] = float("inf"), float("nan"), -float("inf")
    want, got = sref.sketch(tprng.prng_key(1), A, 40, 1), fixed.sketch_fixed_point(tprng.prng_key(1), A, 40, 1)
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    fin = want.isfinite()
    assert torch.equal(torch.sign(got[~fin & ~got.isnan()]), torch.sign(want[~fin & ~want.isnan()]))
    assert _rel(got[fin].numpy(), want[fin].numpy()) <= TOL


@pytest.mark.parametrize("n,m,d,s,long", [(2**20 + 2**16, 111_412, 1, 1, True), (4096, 64, 1, 1, True),
                                          (1000, 200, 8, 20, True), (1000, 200, 9, 20, False),
                                          (500_000, 2500, 251, 20, False), (100, 31_744, 9, 1, False),
                                          (100, 31_745, 9, 1, True), (100, 200, 9, 4096, False)])
def test_sjlt_apply_takes_the_long_entry_by_shape(n, m, d, s, long):
    assert tcuda.sjlt_apply_is_long(n, m, d, s) is long
    if not long and s <= tcuda.SJLT_MAX_PAIRS:
        tcuda.plan_sjlt(n, m, d, s)  # the bin and scatter passes can take it


def test_long_scratch_holds_entries_exponents_counts_and_pairs():
    """Row 12b's scratch: each chunk's count of each group and partition, their
    totals and first entries, the group list (a 32-bit bucket and a float32 value
    a pair) where the sort takes two levels, and each pair's entry (a 16-bit
    bucket, a float32 value); the sums, exponents and counts live in shared
    memory. The pair list (4 B a pair) lies beside it."""
    def a16(b):
        return -(-b // 16) * 16

    def counts(rows, width, parts):
        return a16(4 * rows * width) + a16(4 * parts) + a16(4 * (parts + 1))

    D = 2**28
    plan = tcuda.plan_sjlt_long(D, 26_843_546, 1, 1)
    assert plan.groups > 0
    assert tcuda.sjlt_long_scratch_bytes(D, 26_843_546, 1, 1) == (
        counts(plan.chunks, plan.groups, plan.groups) + 8 * D
        + counts(plan.groups * plan.sub, plan.group_parts, plan.parts) + 6 * D)
    D = 2**20 + 2**16
    tiny = tcuda.plan_sjlt_long(D, 1, 1, 1)
    assert tiny.parts == 1 and tiny.groups == 0
    assert tcuda.sjlt_long_scratch_bytes(D, 1, 1, 1) == counts(tiny.chunks, 1, 1) + 6 * D
