"""The PyTorch port's counter-RNG contract and key derivation against the JAX reference.

Integer streams (threefry words, packed signs, worker key words) must match
bitwise. Gaussian values go through ``log``/``cos`` of another math library, so
they match to a stated tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jc
from repro.utils import prng as jprng
from repro_torch.kernels import common as tc
from repro_torch.utils import env as tenv
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

# |Δz| bound for counter normals: measured ≤ 4.8e-7 over 1e5 draws (|z| ≤ 4.3); 2e-6
# is a few float32 ulps at the largest |z| a 32-bit uniform can give (6.7).
NORMAL_ATOL = 2e-6
K0, K1 = 0x12345678, 0x9ABCDEF0
EDGES = np.array([0, 1, 31, 32, 2**31 - 1, 2**31, 2**32 - 1], np.uint32)


def _counters(seed, count=4096):
    rs = np.random.default_rng(seed)
    c0 = np.concatenate([EDGES, rs.integers(0, 2**32, count, dtype=np.uint64).astype(np.uint32)])
    c1 = np.concatenate([EDGES[::-1], rs.integers(0, 2**32, count, dtype=np.uint64).astype(np.uint32)])
    return c0, c1


def _t(u32: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(u32.astype(np.int64))


@pytest.mark.parametrize("rounds", [20, 8])
def test_threefry_words_bitwise(rounds):
    c0, c1 = _counters(rounds)
    j0, j1 = jc.threefry2x32(jnp.uint32(K0), jnp.uint32(K1), jnp.asarray(c0), jnp.asarray(c1), rounds=rounds)
    t0, t1 = tc.threefry2x32(K0, K1, _t(c0), _t(c1), rounds=rounds)
    np.testing.assert_array_equal(np.asarray(j0).astype(np.int64), t0.numpy())
    np.testing.assert_array_equal(np.asarray(j1).astype(np.int64), t1.numpy())


def test_threefry_broadcasts_and_rejects_bad_rounds():
    rows = torch.arange(5, dtype=torch.int64)[:, None]
    cols = torch.arange(7, dtype=torch.int64)[None, :]
    x0, x1 = tc.threefry2x32(K0, K1, rows, cols)
    assert x0.shape == x1.shape == (5, 7)
    y0, _ = tc.threefry2x32(K0, K1, 3, 4)
    assert int(y0) == int(x0[3, 4])
    for bad in (0, 6, -4):
        with pytest.raises(ValueError, match="multiple of 4"):
            tc.threefry2x32(K0, K1, rows, cols, rounds=bad)


def test_bits_to_open_unit_bitwise():
    c0, _ = _counters(1)
    np.testing.assert_array_equal(np.asarray(jc.bits_to_open_unit(jnp.asarray(c0))), tc.bits_to_open_unit(_t(c0)).numpy())


@pytest.mark.parametrize("rounds", [20, 8])
def test_counter_normal_to_tolerance(rounds):
    c0, c1 = _counters(100 + rounds)
    zj = np.asarray(jc.counter_normal(jnp.uint32(K0), jnp.uint32(K1), jnp.asarray(c0), jnp.asarray(c1), rounds=rounds))
    zt = tc.counter_normal(K0, K1, _t(c0), _t(c1), rounds=rounds).numpy()
    assert zt.dtype == np.float32
    np.testing.assert_allclose(zt, zj, rtol=0, atol=NORMAL_ATOL)


def test_counter_normal_reads_rng_rounds(monkeypatch):
    c0, c1 = _counters(3, 64)
    monkeypatch.setenv("REPRO_RNG_ROUNDS", "8")
    assert tc.rng_rounds() == 8
    np.testing.assert_array_equal(
        tc.counter_normal(K0, K1, _t(c0), _t(c1)).numpy(),
        tc.counter_normal(K0, K1, _t(c0), _t(c1), rounds=8).numpy(),
    )
    monkeypatch.setenv("REPRO_RNG_ROUNDS", "6")
    with pytest.raises(ValueError, match="REPRO_RNG_ROUNDS"):
        tc.rng_rounds()
    monkeypatch.delenv("REPRO_RNG_ROUNDS")
    assert tc.rng_rounds() == tc.DEFAULT_ROUNDS == jc.DEFAULT_ROUNDS


def test_packed_sign_words_and_counter_rademacher_bitwise():
    c0, c1 = _counters(7)
    wj = jc.packed_sign_words(jnp.uint32(K0), jnp.uint32(K1), jnp.asarray(c0), jnp.asarray(c1))
    wt = tc.packed_sign_words(K0, K1, _t(c0), _t(c1))
    np.testing.assert_array_equal(np.asarray(wj).astype(np.int64), wt.numpy())
    sj = jc.counter_rademacher(jnp.uint32(K0), jnp.uint32(K1), jnp.asarray(c0), jnp.asarray(c1))
    np.testing.assert_array_equal(np.asarray(sj), tc.counter_rademacher(K0, K1, _t(c0), _t(c1)).numpy())
    bit = c1 % 32
    uj = jc.unpack_signs(wj, jnp.asarray(bit))
    np.testing.assert_array_equal(np.asarray(uj), tc.unpack_signs(wt, _t(bit)).numpy())


@pytest.mark.parametrize("row0,col0,nrows,ncols", [(0, 0, 8, 64), (3, 32, 5, 96), (40, 4096, 2, 32)])
def test_packed_sign_tile_bitwise(row0, col0, nrows, ncols):
    tj = jc.packed_sign_tile(jnp.uint32(K0), jnp.uint32(K1), row0, col0, nrows, ncols)
    tt = tc.packed_sign_tile(K0, K1, row0, col0, nrows, ncols)
    np.testing.assert_array_equal(np.asarray(tj), tt.numpy())
    with pytest.raises(ValueError, match="multiples of 32"):
        tc.packed_sign_tile(K0, K1, row0, col0 + 1, nrows, ncols)


@pytest.mark.parametrize("col0", [0, 5, 31, 33, 100, 1023])
@pytest.mark.parametrize("ncols", [1, 45, 64])
def test_counter_rademacher_block_unaligned_bitwise(col0, ncols):
    bj = jc.counter_rademacher_block(jnp.uint32(K0), jnp.uint32(K1), 2, col0, 6, ncols)
    bt = tc.counter_rademacher_block(K0, K1, 2, col0, 6, ncols)
    assert bt.shape == (6, ncols)
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())


@pytest.mark.parametrize("seed", [0, 7, 12345, -3, 2**31 - 1])
@pytest.mark.parametrize("round_id", [0, 1, 9])
def test_worker_keys_bitwise(seed, round_id):
    base = jax.random.PRNGKey(seed)
    tkey = tprng.prng_key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(base)).astype(np.int64), tkey.numpy())
    want = np.asarray(jax.random.key_data(jprng.worker_keys(base, 5, round_id))).astype(np.int64)
    np.testing.assert_array_equal(tprng.worker_keys(tkey, 5, round_id).numpy(), want)
    one = np.asarray(jax.random.key_data(jprng.worker_key(base, 3, round_id))).astype(np.int64)
    np.testing.assert_array_equal(tprng.worker_key(tkey, 3, round_id).numpy(), one)


def test_fold_in_and_key_data_round_trip():
    base = jax.random.PRNGKey(11)
    for data in (0, 1, 2**31 + 5):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(base, data))).astype(np.int64)
        np.testing.assert_array_equal(tprng.fold_in(tprng.prng_key(11), data).numpy(), want)
    keys = jprng.worker_keys(base, 3)
    words = tprng.from_key_data(np.asarray(jax.random.key_data(keys)))
    assert words.shape == (3, 2) and words.dtype == torch.int64
    with pytest.raises(ValueError, match="uint32"):
        tprng.from_key_data(np.zeros((2,), np.int64))
    with pytest.raises(ValueError, match="32 signed bits"):
        tprng.prng_key(2**31)


def test_key_words_and_round_up():
    assert tc.key_words(torch.tensor([5, 2**32 - 1])) == (5, 2**32 - 1)
    with pytest.raises(ValueError, match=r"\(2,\)"):
        tc.key_words(torch.zeros((3, 2), dtype=torch.int64))
    assert [tc.round_up(x, 32) for x in (1, 32, 33)] == [jc.round_up(x, 32) for x in (1, 32, 33)] == [32, 32, 64]
    assert tc.inv_sqrt(2500) == float(np.float32(1 / 50))


@pytest.mark.parametrize(
    "raw,want", [("1", True), ("yes", True), ("off", False), ("", None)]
)
def test_env_copy_matches_reference_parsing(monkeypatch, raw, want):
    from repro.utils import env as jenv

    monkeypatch.setenv("REPRO_TORCH_TEST_FLAG", raw)
    assert tenv.read_bool("REPRO_TORCH_TEST_FLAG") is want
    assert jenv.read_bool("REPRO_TORCH_TEST_FLAG") is want
    monkeypatch.setenv("REPRO_TORCH_TEST_INT", "12")
    assert tenv.read_int("REPRO_TORCH_TEST_INT", 20, positive=True, multiple_of=4) == 12
    monkeypatch.setenv("REPRO_TORCH_TEST_INT", "x")
    with pytest.raises(ValueError, match="REPRO_TORCH_TEST_INT"):
        tenv.read_int("REPRO_TORCH_TEST_INT")


# jax's threefry split / bits / randint in partitionable mode (the reference's jax
# default), which the SRHT's row picks go through.
SPLIT_SEEDS = [0, 7, -3, 2**31 - 1]


@pytest.mark.parametrize("seed", SPLIT_SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_bitwise(seed, num):
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.key_data(jax.random.split(jkey, num))).astype(np.int64)
    np.testing.assert_array_equal(tprng.split(tprng.prng_key(seed), num).numpy(), want)


@pytest.mark.parametrize("shape", [(1,), (4, 7), (3, 1, 5)])
def test_random_bits_bitwise(shape):
    jkey = jax.random.PRNGKey(13)
    want = np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64)
    got = tprng.random_bits(tprng.prng_key(13), shape)
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


# Spans that are and are not powers of two: for 2**19 (the SRHT's n_pad at FIG3A)
# jax's multiplier (2**16 mod span)**2 wraps to 0 in uint32.
RANDINT_BOUNDS = [(0, 2**19), (0, 1024), (0, 1), (0, 1000), (0, 3**19), (-5, 17), (0, 2**31 - 1),
                  (-(2**31), 2**31 - 1), (5, 5), (7, 3)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("lo,hi", RANDINT_BOUNDS)
def test_randint_bitwise(seed, lo, hi):
    jkey = jax.random.PRNGKey(seed)
    want = np.asarray(jax.random.randint(jkey, (257,), lo, hi)).astype(np.int64)
    got = tprng.randint(tprng.prng_key(seed), (257,), lo, hi)
    np.testing.assert_array_equal(got.numpy(), want)


def test_batched_keys_draw_as_vmapped_jax():
    jkeys = jprng.worker_keys(jax.random.PRNGKey(3), 4, 2)
    tkeys = tprng.from_key_data(np.asarray(jax.random.key_data(jkeys)))
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (50,), 0, 1024))(jkeys)).astype(np.int64)
    np.testing.assert_array_equal(tprng.randint(tkeys, (50,), 0, 1024).numpy(), want)
    want = np.asarray(jax.vmap(lambda k: jax.random.key_data(jax.random.split(k)))(jkeys)).astype(np.int64)
    np.testing.assert_array_equal(tprng.split(tkeys).numpy(), want)
    with pytest.raises(ValueError, match="int32"):
        tprng.randint(tkeys, (2,), 0, 2**31)
    with pytest.raises(ValueError, match=r"\(\.\.\., 2\)"):
        tprng.split(torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("s", [1, 4, 20])
@pytest.mark.parametrize("m", [1, 40, 2500, 2**31 - 1])
def test_sjlt_counter_params_bitwise(s, m):
    rows = np.concatenate([EDGES, np.random.default_rng(s).integers(0, 2**32, 300, dtype=np.uint64).astype(np.uint32)])
    bj, sj = jc.sjlt_counter_params(jnp.uint32(K0), jnp.uint32(K1), jnp.asarray(rows), s, m)
    bt, st = tc.sjlt_counter_params(K0, K1, _t(rows), s, m)
    assert bt.shape == st.shape == (rows.size, s) and st.dtype == torch.float32
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj).astype(np.int64))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# jax's float draws (uniform, gumbel in mode "low", categorical with replacement)
# and the gumbel top-k pick without replacement, bitwise: the port repeats XLA's
# CPU float32 logarithm (``prng.xla_log``) operation for operation.
UNIFORM_BOUNDS = [(0.0, 1.0), (-3.5, 2.25), (0.1, 0.7), (float(np.finfo(np.float32).tiny), 1.0)]


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("lo,hi", UNIFORM_BOUNDS)
def test_uniform_bitwise(seed, lo, hi):
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (3, 1001), minval=lo, maxval=hi))
    got = tprng.uniform(tprng.prng_key(seed), (3, 1001), lo, hi)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("shape", [(4097,), (37, 300)])
def test_gumbel_bitwise(seed, shape):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), shape))
    np.testing.assert_array_equal(tprng.gumbel(tprng.prng_key(seed), shape).numpy(), want)


def test_gumbel_of_every_uniform_matches_jax_and_rises_with_its_bits():
    """All 2**23 uniforms a gumbel can start from: the port's -log(-log(u)) equals
    jax's bitwise, and rises strictly with the 23 bits (what lets
    ``gumbel_top_k`` sort the bits instead of the gumbels)."""
    bits = np.arange(2**23, dtype=np.uint32)
    tiny = np.finfo(np.float32).tiny
    u = np.maximum((bits | np.uint32(0x3F800000)).view(np.float32) - np.float32(1), np.float32(tiny))
    want = np.asarray(jax.jit(lambda v: -jnp.log(-jnp.log(v)))(jnp.asarray(u)))
    got = (-tprng.xla_log(-tprng.xla_log(torch.from_numpy(u)))).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(want) > 0)


@pytest.mark.parametrize("lo,hi", [(-126, -100), (-100, -20), (-20, 0), (0, 20), (20, 128)])
def test_xla_log_bitwise(lo, hi):
    rs = np.random.default_rng(lo + 200)
    x = ((rs.random(1 << 18) + 1) * 2.0 ** rs.integers(lo, hi, 1 << 18)).astype(np.float32)
    x = x[np.isfinite(x)]
    np.testing.assert_array_equal(tprng.xla_log(torch.from_numpy(x)).numpy(), np.asarray(jnp.log(jnp.asarray(x))))


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("n,k", [(500_000, 25_000), (1000, 500), (1000, 1000), (1, 1), (2, 1), (31, 16)])
def test_gumbel_top_k_order_bitwise(seed, n, k):
    """``top_k(gumbel(key, (n,)), k)[1]``, order included: FIG3A's n and m′ (about
    15,000 pairs of equal gumbels among 500,000), and k = n/2 and k = n."""
    want = np.asarray(jax.lax.top_k(jax.random.gumbel(jax.random.PRNGKey(seed), (n,)), k)[1])
    np.testing.assert_array_equal(tprng.gumbel_top_k(tprng.prng_key(seed), n, k).numpy(), want.astype(np.int64))


def test_gumbel_top_k_rejects_more_than_n():
    with pytest.raises(ValueError, match="without replacement"):
        tprng.gumbel_top_k(tprng.prng_key(0), 5, 6)


@pytest.mark.parametrize("seed", [0, 7, 2**31 - 1])
@pytest.mark.parametrize("m,n", [(40, 1001), (1, 3), (300, 64)])
def test_categorical_bitwise(seed, m, n, monkeypatch):
    """``categorical(key, logits, shape=(m,))`` with logits log(p + 1e-30) as the
    leverage sketch makes them (p with an exact float32 sum), drawn whole and in
    pieces of a few rows."""
    rs = np.random.default_rng(seed % 1000 + n)
    sc = rs.integers(1, 1000, n).astype(np.float32) / 256
    p = sc / sc.sum()
    jl = jnp.log(jnp.asarray(p) + 1e-30)
    tl = tprng.xla_log(torch.from_numpy(p) + 1e-30)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), jl, shape=(m,))).astype(np.int64)
    got = tprng.categorical(tprng.prng_key(seed), tl, m)
    np.testing.assert_array_equal(got.numpy(), want)
    monkeypatch.setattr(tprng, "CATEGORICAL_PIECE", 3 * n)
    np.testing.assert_array_equal(tprng.categorical(tprng.prng_key(seed), tl, m).numpy(), want)


@pytest.mark.parametrize("shape,offset", [((6, 7), 0), ((3, 7), 21), ((2, 5), 2**32 - 3)])
def test_draws_in_pieces_equal_the_whole(shape, offset):
    """A draw at a flat offset is that slice of the whole draw; counters past
    2**32 carry into the high word as jax's do."""
    key = tprng.prng_key(9)
    size = int(np.prod(shape))
    whole = jax.random.bits(jax.random.PRNGKey(9), (offset + size,), jnp.uint32) if offset < 2**20 else None
    got = tprng.random_bits(key, shape, offset=offset)
    if whole is not None:
        np.testing.assert_array_equal(got.reshape(-1).numpy(), np.asarray(whole)[offset:].astype(np.int64))
    x0, x1 = tc.threefry2x32(key[0], key[1], (offset + np.arange(size)) >> 32, (offset + np.arange(size)) & 0xFFFFFFFF)
    torch.testing.assert_close(got.reshape(-1), x0 ^ x1, rtol=0, atol=0)
    g = tprng.gumbel(key, shape, offset=offset)
    assert g.shape == shape and bool(torch.isfinite(g).all())
