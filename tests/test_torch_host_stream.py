"""The port's out-of-core Gram (``operators.gram_blocked_host``) on the CPU,
against the JAX reference's ``gram_blocked_host`` and the port's own
``gram_blocked`` on the same numpy data.

A is a numpy array or an ``np.memmap``, b a vector, a matrix or None; block
sizes divide n or leave a short last tile. Tolerance: max |ΔG| / max |G| and
the same for c at 1e-5 (float32 sums of the same products in other orders;
the Gaussian's normals also differ by float32 ulps between the packages).
With ``use_kernel=True`` on the CPU the S·A wrappers run their plain versions
at each tile's row offset, so that route is checked here too; the card's
kernels are held to it in ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import operators as jops, sketches as jsk
from repro_torch.core import operators as tops, sketches as tsk
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

N, D, M = 901, 6, 24
TOL = 1e-5
KINDS = ["gaussian", "rademacher", "sjlt", "srht", "uniform", "uniform_norep", "hybrid_sjlt", "hybrid_gaussian"]


def _spec(sk, kind, **kw):
    if kind == "uniform_norep":
        return sk.SketchSpec("uniform", M, replacement=False, **kw)
    if kind.startswith("hybrid_"):
        return sk.SketchSpec("hybrid", M, m_prime=5 * M, inner=kind[7:], s=4, **kw)
    return sk.SketchSpec(kind, M, s=4, **kw)


def _data(tmp_path, form: str, bform: str):
    rs = np.random.default_rng(11)
    A = rs.standard_normal((N, D)).astype(np.float32)
    b = {"vector": rs.standard_normal(N).astype(np.float32),
         "matrix": rs.standard_normal((N, 2)).astype(np.float32), "none": None}[bform]
    if form == "memmap":
        path = tmp_path / "A.f32"
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=(N, D))
        mm[:] = A
        mm.flush()
        A = np.memmap(path, dtype=np.float32, mode="r", shape=(N, D))
    return A, b


def _close(got, want):
    if want is None:
        assert got is None
        return
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _against_reference(tmp_path, kind, use_kernel, form, block_rows):
    A, b = _data(tmp_path, form, "vector")
    Gj, cj = jops.gram_blocked_host(_spec(jsk, kind), jax.random.PRNGKey(3), A, b, block_rows=block_rows)
    Gt, ct = tops.gram_blocked_host(_spec(tsk, kind, use_kernel=use_kernel), tprng.prng_key(3), A, b,
                                    block_rows=block_rows, device="cpu")
    _close(Gt, Gj)
    _close(ct, cj)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_host_stream_matches_reference(tmp_path, kind, use_kernel):
    """Every kind, both routes, at tiles of 128 rows (the last one 5 rows)."""
    _against_reference(tmp_path, kind, use_kernel, "numpy", 128)


@pytest.mark.parametrize("block_rows", [100, 901, 4096])
@pytest.mark.parametrize("form", ["numpy", "memmap"])
@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_host_stream_forms_and_block_sizes(tmp_path, kind, form, block_rows):
    """A numpy array or a memmap, a block size that divides n into a short last
    tile, one tile of exactly n rows, and one larger than n: the form and the
    tiling do not depend on the kind, so two kernel kinds stand for all."""
    _against_reference(tmp_path, kind, True, form, block_rows)


@pytest.mark.parametrize("bform", ["vector", "matrix", "none"])
@pytest.mark.parametrize("block_rows", [97, 300])
@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "sjlt", "srht", "hybrid_sjlt"])
def test_host_stream_matches_gram_blocked(tmp_path, kind, block_rows, bform):
    A, b = _data(tmp_path, "numpy", bform)
    spec = _spec(tsk, kind, use_kernel=True)
    key = tprng.prng_key(8)
    Gt, ct = tops.gram_blocked_host(spec, key, A, b, block_rows=block_rows, device="cpu")
    Gw, cw = tops.gram_blocked(spec, key, torch.from_numpy(A), None if b is None else torch.from_numpy(b))
    _close(Gt, Gw)
    _close(ct, cw)


def test_host_stream_leverage_takes_scores(tmp_path):
    A, b = _data(tmp_path, "numpy", "vector")
    scores = np.linspace(0.5, 2.0, N).astype(np.float32)
    Gj, cj = jops.gram_blocked_host(jsk.SketchSpec("leverage", M), jax.random.PRNGKey(1), A, b,
                                    block_rows=200, scores=jax.numpy.asarray(scores))
    Gt, ct = tops.gram_blocked_host(tsk.SketchSpec("leverage", M), tprng.prng_key(1), A, b, block_rows=200,
                                    scores=torch.from_numpy(scores), device="cpu")
    _close(Gt, Gj)
    _close(ct, cj)


def test_host_stream_rerun_is_bitwise_and_refuses_bad_input():
    A = np.random.default_rng(0).standard_normal((300, 4)).astype(np.float32)
    spec = tsk.SketchSpec("sjlt", 16, s=4, use_kernel=True)
    one = tops.gram_blocked_host(spec, tprng.prng_key(0), A, None, block_rows=64, device="cpu")[0]
    two = tops.gram_blocked_host(spec, tprng.prng_key(0), A, None, block_rows=64, device="cpu")[0]
    assert torch.equal(one, two)
    with pytest.raises(ValueError, match="shape"):
        tops.gram_blocked_host(spec, tprng.prng_key(0), A[:, 0], None, device="cpu")


@pytest.mark.parametrize("row0", [0, 32, 77])
@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "sjlt"])
def test_row_offset_tiles_sum_to_whole(kind, row0):
    """The plain versions' row offset: the S·A of a tile at row0 is the S·A of A
    with every other row zeroed, and the tiles add up to the whole S·A."""
    from repro_torch.kernels.gaussian import ops as gops
    from repro_torch.kernels.rademacher import ops as rops
    from repro_torch.kernels.sjlt import ops as sops

    fn = {"gaussian": lambda k, X, r: gops.gaussian_sketch(k, X, M, row0=r),
          "rademacher": lambda k, X, r: rops.rademacher_sketch(k, X, M, row0=r),
          "sjlt": lambda k, X, r: sops.sjlt_apply(k, X, M, 4, row0=r)}[kind]
    X = torch.from_numpy(np.random.default_rng(row0).standard_normal((400, 5)).astype(np.float32))
    key = tprng.prng_key(21)
    whole = fn(key, X, 0)
    tile = fn(key, X[row0 : row0 + 150], row0)
    masked = torch.zeros_like(X)
    masked[row0 : row0 + 150] = X[row0 : row0 + 150]
    np.testing.assert_allclose(tile.numpy(), fn(key, masked, 0).numpy(), rtol=0,
                               atol=TOL * float(tile.abs().max()))
    parts = sum(fn(key, X[j : j + 150], j) for j in range(0, 400, 150))
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=0, atol=TOL * float(whole.abs().max()))
