"""The port's SRHT forward S·A (``fwht.ops.srht_forward``, ``SRHTOp.apply``) on the CPU.

Its plain version is the composition ``SRHTOp.apply`` made before the fused
kernel (D·A, zero rows up to n_pad, the full FWHT, the sampled rows times
1/√m), bitwise; ``SRHTOp.apply`` on the CPU, with and without ``use_kernel``,
is held against the JAX package's ``SRHTOp.apply`` (its Pallas FWHT in interpret
mode with ``use_kernel``) on the same numpy inputs and worker key. Both sum
n_pad terms in float32 in other orders (butterflies against Kronecker
products), so an entry of H·D·A may differ by 1e-5·√n_pad·max|A| at most, as for
the FWHT alone; the entries of S·A are those times 1/√m.

A numpy model of ``csrc/fwht.cu``'s ``repro_srht_forward`` (its passes, the rows
each pass reads as zeros and the groups it leaves unwritten, the last pass's
groups and the sampled positions each one's block finds by scanning the ids)
runs on a scratch and an output filled with NaN, and must give the plain
version's bits; the blocks' scan, in the order its warps write, is held against
numpy's grouping of the ids.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import operators as jops, sketches as jsk
from repro_torch.core import operators as tops, sketches as tsk
from repro_torch.kernels import common as tc, cuda as tcuda
from repro_torch.kernels.fwht import ops as fops, ref as fref
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

# (n, k, m): n_pad = 2^0 to 2^12, n a power of two and ragged, m > n_pad (every
# row sampled, most more than once) and m < n_pad.
CASES = [(1, 1, 3), (2, 5, 7), (5, 1, 40), (64, 5, 40), (100, 5, 300), (1024, 1, 40), (1500, 5, 200),
         (4096, 1, 50), (3000, 5, 5000)]


def _keys(seed):
    jkey = jax.random.PRNGKey(seed)
    return jkey, tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))


def _A(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


def _op(n, m, seed, use_kernel=False):
    _, tkey = _keys(seed)
    return tops.make_operator(tsk.SketchSpec("srht", m, use_kernel=use_kernel), tkey, n)


@pytest.mark.parametrize("n,k,m", CASES)
def test_plain_forward_is_the_composition_bitwise(n, k, m):
    op = _op(n, m, n + k)
    A = torch.from_numpy(_A(n, k, n))
    DA = A * fref.diagonal(op.kd0, op.kd1, torch.arange(n))[:, None]
    padded = torch.cat([DA, torch.zeros((op.n_pad - n, k))])
    want = fref.fwht(padded)[op.rows] * tc.inv_sqrt(m)
    got = fref.srht_forward(op.kd0, op.kd1, op.rows, A, op.n_pad)
    assert got.dtype == torch.float32 and got.shape == (m, k)
    assert torch.equal(got, want)


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("n,k,m", CASES)
def test_apply_matches_the_reference(n, k, m, use_kernel):
    """``SRHTOp.apply`` on the CPU against the JAX package's on the same key and A."""
    jkey, tkey = _keys(3 * n + k)
    A = _A(n, k, 7 + n)
    jop = jops.make_operator(jsk.SketchSpec("srht", m, use_kernel=use_kernel), jkey, n)
    top = tops.make_operator(tsk.SketchSpec("srht", m, use_kernel=use_kernel), tkey, n)
    before = dict(fops.LAUNCHES)
    got = top.apply(torch.from_numpy(A))
    assert dict(fops.LAUNCHES) == before  # the plain version on a CPU tensor
    want = np.asarray(jop.apply(jnp.asarray(A)))
    assert got.shape == want.shape == (m, k)
    atol = 1e-5 * np.sqrt(top.n_pad) * np.abs(A).max() * tc.inv_sqrt(m)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # the (n,) form: one column, batch shape kept
    got1 = top.apply(torch.from_numpy(A[:, 0].copy()))
    assert got1.shape == (m,) and torch.equal(got1, got[:, 0])


def test_repeated_rows_are_written_at_every_position():
    op = _op(10, 300, 1)  # 300 draws of 16 rows: every row drawn many times
    rows = op.rows.numpy()
    assert len(set(rows.tolist())) < len(rows)
    got = fref.srht_forward(op.kd0, op.kd1, op.rows, torch.from_numpy(_A(10, 3, 2)), op.n_pad)
    for p, r in enumerate(rows):
        first = int(np.flatnonzero(rows == r)[0])
        assert torch.equal(got[p], got[first])


def test_wrapper_is_the_plain_version_on_cpu_and_refuses_other_devices():
    op = _op(100, 20, 4)
    A = torch.from_numpy(_A(100, 5, 5))
    before = dict(fops.LAUNCHES)
    got = fops.srht_forward(op.kd0, op.kd1, op.rows, A, op.n_pad)
    assert dict(fops.LAUNCHES) == before
    assert torch.equal(got, fref.srht_forward(op.kd0, op.kd1, op.rows, A, op.n_pad))
    with pytest.raises(ValueError, match="CUDA kernel"):
        fops.srht_forward(op.kd0, op.kd1, op.rows, torch.empty((100, 5), device="meta"), op.n_pad)


@pytest.mark.parametrize("n", [1, 2, 1024, 2048, 2**15, 2**19, 2**20, 2**21, 2**30])
def test_packed_plan_is_the_plan(n):
    """The C entries take plan_fwht's stage counts packed 4 bits a pass."""
    packed, passes = tcuda._packed_fwht_plan(n)
    assert tuple((packed >> (4 * p)) & 15 for p in range(passes)) == tcuda.plan_fwht(n)
    assert packed >> (4 * passes) == 0


# --------------------------------------------------------- model of the C entry


def _stages(x, lo, t):
    """Stages h = 2^lo .. 2^(lo+t-1) of the butterfly on rows of x (float32), in order."""
    for s in range(lo, lo + t):
        h = 1 << s
        v = x.reshape(-1, 2, h, x.shape[-1])
        a, b = v[:, 0].copy(), v[:, 1].copy()
        v[:, 0], v[:, 1] = a + b, a - b
    return x


def _last_pass_hits(ids, lo, threads):
    """Per group g < 2^lo of the last pass: what its block's scan finds, in the
    order its warps write them. Thread x of the block reads the ids
    s·threads + x; bit s of its hit mask is set when that id's low lo bits are
    g (past MASK_CHUNKS chunks it reads the id again when it writes); then, for
    each chunk s, each warp w writes the positions s·threads + 32·w + lane of
    its set bits, lowest lane first: (p, row in group ids[p] >> lo)."""
    hits = {g: [] for g in range(1 << lo)}
    for s in range(-(-len(ids) // threads)):
        for w in range(threads // 32):
            for lane in range(32):
                p = s * threads + 32 * w + lane
                if p < len(ids):  # every block tests this id; the block of its residue writes it
                    hits[int(ids[p]) & ((1 << lo) - 1)].append((p, int(ids[p]) >> lo))
    return hits


def _last_pass(n_pad):
    """(lo, threads) of plan_fwht's last pass at n_pad: the stages before it, and
    its block's threads (512 for the 10-stage tile, 256 below)."""
    t = tcuda.plan_fwht(n_pad)[-1]
    return n_pad.bit_length() - 1 - t, 512 if t == tcuda.FWHT_MAX_TILE_BITS else 256


def _model_srht_forward(kd0, kd1, ids, A, n_pad):
    """numpy model of ``repro_srht_forward``: the passes of plan_fwht; rows at or
    past valid_in read as zeros; a non-last pass writes only spans that start
    below valid_out = round_up(valid_in, 2^(lo+t)); the last writes each group's
    sampled positions. Scratch and output start as NaN."""
    n, k = A.shape
    m = len(ids)
    plan = tcuda.plan_fwht(n_pad)
    signs = fref.diagonal(kd0, kd1, torch.arange(n)).numpy()
    ld = -(-k // tcuda.FWHT_SCRATCH_ALIGN) * tcuda.FWHT_SCRATCH_ALIGN
    scratch = np.full((n_pad, ld), np.nan, np.float32)
    out = np.full((m, k), np.nan, np.float32)
    src, valid_in, lo = np.asarray(A, np.float32) * signs[:, None], n, 0
    for q, t in enumerate(plan):
        x = np.zeros((n_pad, k), np.float32)
        x[:valid_in] = src[:valid_in, :k]
        _stages(x, lo, t)
        if q == len(plan) - 1:
            hits = _last_pass_hits(ids, lo, _last_pass(n_pad)[1])
            assert sorted(p for h in hits.values() for p, _ in h) == list(range(m))
            for g, h in hits.items():
                for p, i in h:
                    assert i < 1 << t and g + (i << lo) == ids[p]
                    out[p] = x[g + (i << lo)] * np.float32(tc.inv_sqrt(m))
        else:
            valid_out = -(-valid_in // (1 << (lo + t))) * (1 << (lo + t))
            scratch[:valid_out, :k] = x[:valid_out]
            src, valid_in = scratch, valid_out
        lo += t
    return out


@pytest.mark.parametrize("n,k,m,n_pad", [(1, 2, 5, 1), (700, 3, 50, 1024), (1500, 5, 40, 2048),
                                         (1025, 2, 30, 2048), (2**15 - 3000, 1, 300, 2**15),
                                         (2**20 + 5, 1, 64, 2**21), (3, 1, 2**12, 4)])
def test_model_of_the_kernel_is_the_plain_version_bitwise(n, k, m, n_pad):
    op = _op(n, m, n + m)
    assert op.n_pad == n_pad
    A = _A(n, k, m)
    got = _model_srht_forward(op.kd0, op.kd1, op.rows.numpy(), A, n_pad)
    want = fref.srht_forward(op.kd0, op.kd1, op.rows, torch.from_numpy(A), n_pad).numpy()
    assert not np.isnan(got).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_pad,m", [(2**19, 2500), (2**15, 2500), (2**10, 200), (1, 3), (4, 40), (2**11, 9000)])
def test_last_pass_row_selection(n_pad, m):
    """The positions each last-pass block finds by scanning the ids land in exactly
    the group of their residue mod 2^lo (lo: the stages before the last pass),
    repeats included, each once, a group's positions in sample order; against
    numpy (2^11 with m = 9,000: past the 32 chunks a thread keeps bits of)."""
    rs = np.random.default_rng(n_pad + m)
    ids = rs.integers(0, n_pad, m)
    ids[m // 2:] = ids[: m - m // 2]  # repeats
    lo, threads = _last_pass(n_pad)
    if n_pad == 2**11:
        assert m > 32 * threads
    hits = _last_pass_hits(ids, lo, threads)
    want = {g: np.flatnonzero((ids & ((1 << lo) - 1)) == g).tolist() for g in range(1 << lo)}
    assert {g: [p for p, _ in h] for g, h in hits.items()} == want
    assert all(i == ids[p] >> lo for h in hits.values() for p, i in h)
    if n_pad == 2**19:  # FIG3A: some of the 1,024 groups hold no sampled row and skip their reads
        assert 0 < sum(not h for h in hits.values()) < 1024
