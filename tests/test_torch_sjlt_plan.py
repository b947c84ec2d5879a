"""The SJLT kernels' plan (``kernels/cuda.py`` ``plan_sjlt``), their worker
chunks, and the order of the bin pass's pair list, on the CPU. No card is needed.

The plan is what keeps a worker's SJLT Gram and S·A bitwise the same alone or
among q, and what the C entry checks before it launches. The list premise: the
plain twin of the bin pass (``sjlt.ref.bin_pairs``) is bitwise the pairs the JAX
reference draws (``repro.kernels.common.sjlt_counter_params``), binned the same
way here with numpy (by chunk, m-tile, owner class, then pair order, each bin
padded to a multiple of 4 entries with its class's spare row), and the
S·A added back from the list (``sjlt.ref.sketch_from_bins``) is within 1e-6 of
each column's rms of the plain segment sum (``sjlt.ref.sketch``): both sum in
float64 and round once, in other orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import common as jcommon
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels.sjlt import ref as sref

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

# (n, m, d'): FIG3A's full n and m′ rows, FIG4A's Aᵀ and the hybrid's m′ rows of
# it, m past one m-tile (2,500 to 12,000 rows), d′ not a multiple of the 32-column
# tile, n not a multiple of a chunk, n below one.
SHAPES = [(500_000, 2500, 251), (25_000, 2500, 251), (1000, 200, 50), (500, 200, 50), (2000, 3100, 40),
          (777, 1536, 5), (1500, 1537, 33), (300, 12_000, 9), (4097, 64, 257), (33, 1, 1), (5, 40, 3)]
S_VALUES = [1, 4, 20]


@pytest.mark.parametrize("s", S_VALUES)
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_sjlt_plan_is_a_function_of_the_shapes_only(n, m, d, s, monkeypatch):
    plan = tcuda.plan_sjlt(n, m, d, s)
    tcuda.plan_sjlt.cache_clear()
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 1 << 20)  # the chunk changes, the plan does not
    assert tcuda.plan_sjlt(n, m, d, s) == plan
    tcuda.plan_sjlt.cache_clear()
    assert tcuda._splits("sjlt", n, m, d, s) == plan.n_splits
    for q in (1, 2, 200):
        tcuda.worker_chunk(n, m, d, q, family="sjlt", s=s)
        assert tcuda.plan_sjlt(n, m, d, s) == plan


@pytest.mark.parametrize("s", S_VALUES)
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_sjlt_splits_are_whole_chunks_cover_n_and_none_is_empty(n, m, d, s):
    plan = tcuda.plan_sjlt(n, m, d, s)
    assert plan.chunk_rows == min(tcuda.SJLT_MAX_CHUNK_ROWS, tcuda.SJLT_MAX_PAIRS // s)
    assert plan.pairs == plan.chunk_rows * s <= tcuda.SJLT_MAX_PAIRS
    assert plan.chunks == -(-n // plan.chunk_rows)
    assert plan.rows_per_split % plan.chunk_rows == 0
    assert (plan.n_splits - 1) * plan.rows_per_split < n <= plan.n_splits * plan.rows_per_split
    assert 1 <= plan.n_splits <= min(plan.chunks, tcuda.MAX_GRID_Y)


@pytest.mark.parametrize("s", S_VALUES)
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_sjlt_scatter_block_fits_the_card(n, m, d, s):
    """The fewest balanced m-tiles whose scatter block fits: the ring and the
    accumulator (its spare rows too) fit a block's shared memory, an entry can
    address every accumulator row, the bins fit the list's header."""
    plan = tcuda.plan_sjlt(n, m, d, s)
    assert plan.d_tiles == -(-d // tcuda.SJLT_BLOCK_COLS)
    assert plan.m_tiles == -(-m // plan.bucket_tile)
    assert (plan.m_tiles - 1) * plan.bucket_tile < m <= plan.m_tiles * plan.bucket_tile
    assert plan.smem_bytes <= tcuda.SJLT_SMEM
    assert (plan.spare_row + tcuda.SJLT_CLASSES) * tcuda.SJLT_BLOCK_COLS <= tcuda.SJLT_MAX_ACC
    assert plan.spare_row >= plan.bucket_tile and plan.spare_row % tcuda.SJLT_CLASSES == 0
    assert plan.bins == plan.m_tiles * tcuda.SJLT_CLASSES <= tcuda.SJLT_MAX_BINS
    assert plan.region_ints % 4 == 0 and plan.hdr_ints % 4 == 0  # whole 16 bytes: one bulk copy a chunk
    assert plan.hdr_ints > plan.bins
    assert tcuda._sjlt_fits(plan.m_tiles, plan.bucket_tile, plan.chunk_rows, plan.pairs)
    if plan.m_tiles > 1:  # one m-tile fewer would not fit
        t = plan.m_tiles - 1
        assert not tcuda._sjlt_fits(t, -(-m // t), plan.chunk_rows, plan.pairs)


@pytest.mark.parametrize("n,m,d,blocks", [(1000, 200, 50, 32), (500, 200, 50, 16), (25_000, 2500, 251, 528)])
def test_sjlt_plan_fills_the_card_at_the_path_shapes(n, m, d, blocks):
    """FIG4A's Aᵀ (1,000 × 50) and its hybrid rows (500 × 50) launched 2 scatter
    blocks on the plan of 16-chunk splits; now one-chunk splits give tens. The
    hybrid's m′ = 25,000 rows launched 256; now more."""
    plan = tcuda.plan_sjlt(n, m, d, 20)
    assert plan.blocks == blocks
    if n <= 1000:
        assert plan.rows_per_split == plan.chunk_rows  # one chunk a split
    else:
        assert plan.blocks > 256


def test_sjlt_plan_at_fig3a():
    """FIG3A (n = 500,000, d′ = 251, m = 2,500, s = 20): two m-tiles of 1,250
    sketch rows by 32 columns a block (160 KB of accumulator and its spare
    rows), 8 column tiles × 2 m-tiles × 33 splits; each worker keeps 33 partials
    and a 48 MB pair list (1,280 pairs a chunk and at most 3 pads in each of its
    64 bins), so 16 workers fit the 2 GiB scratch and a q = 200 master solve
    makes 13 calls into the C entry."""
    n, m, d = 500_000, 2500, 251
    plan = tcuda.plan_sjlt(n, m, d, 20)
    assert (plan.bucket_tile, plan.m_tiles, plan.d_tiles, plan.n_splits) == (1250, 2, 8, 33)
    assert (plan.chunk_rows, plan.chunks, plan.blocks, plan.spare_row) == (64, 7813, 528, 1280)
    assert plan.region_ints == 68 + 1280 + 3 * 64 and plan.list_ints == 7813 * 1540
    per_worker = tcuda.worker_scratch_bytes("sjlt", n, m, d, 20)
    assert per_worker == 4 * (33 * m * d + 7813 * 1540)
    chunk = tcuda.worker_chunk(n, m, d, 200, family="sjlt", s=20)
    assert chunk == tcuda.SCRATCH_BYTES // per_worker == 16
    assert -(-200 // chunk) == 13


@pytest.mark.parametrize("q", [1, 8, 200])
@pytest.mark.parametrize("s", S_VALUES)
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_sjlt_worker_chunk_counts_the_pair_list(n, m, d, s, q, monkeypatch):
    """Each worker's partials and binned pair list fit the scratch together; with
    room for two workers' partials alone, the list makes the chunk one worker."""
    plan = tcuda.plan_sjlt(n, m, d, s)
    chunk = tcuda.worker_chunk(n, m, d, q, family="sjlt", s=s)
    per_worker = 4 * (plan.n_splits * m * d + plan.list_ints)
    assert tcuda.worker_scratch_bytes("sjlt", n, m, d, s) == per_worker
    assert 1 <= chunk <= q and (chunk == 1 or chunk * per_worker <= tcuda.SCRATCH_BYTES)
    assert tcuda.worker_scratch_bytes("sjlt", n, m, d, s, apply=True) == per_worker  # the S·A keeps both too
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 2 * per_worker)
    assert tcuda.worker_chunk(n, m, d, q, family="sjlt", s=s) == min(q, 2)
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 2 * 4 * plan.n_splits * m * d)
    assert tcuda.worker_chunk(n, m, d, q, family="sjlt", s=s) == 1


@pytest.mark.parametrize("s,m", [(0, 10), (tcuda.SJLT_MAX_PAIRS + 1, 10), (20, 10**6)])
def test_sjlt_plan_refuses_what_the_kernels_cannot_take(s, m):
    with pytest.raises(ValueError):
        tcuda.plan_sjlt(1000, m, 8, s)


def test_sjlt_plan_takes_s_at_its_limit():
    plan = tcuda.plan_sjlt(1000, 50, 8, tcuda.SJLT_MAX_PAIRS)
    assert (plan.chunk_rows, plan.pairs, plan.chunks) == (1, tcuda.SJLT_MAX_PAIRS, 1000)


def _reference_list(k0: int, k1: int, n: int, m: int, s: int, plan) -> np.ndarray:
    """The list from the JAX reference's pairs, binned with numpy."""
    buckets, signs = jcommon.sjlt_counter_params(jnp.uint32(k0), jnp.uint32(k1), jnp.arange(n), s, m)
    b = np.asarray(buckets, dtype=np.int64).reshape(-1)
    neg = (np.asarray(signs).reshape(-1) < 0).astype(np.int64)
    rows = np.repeat(np.arange(n, dtype=np.int64), s)
    chunk, r = rows // plan.chunk_rows, rows % plan.chunk_rows
    tile = b // plan.bucket_tile
    lb = b - tile * plan.bucket_tile
    bin_ = tile * tcuda.SJLT_CLASSES + lb % tcuda.SJLT_CLASSES
    ent = (lb * tcuda.SJLT_BLOCK_COLS) | ((r * 32) << 16) | (neg << 31)
    out = np.zeros((plan.chunks, plan.region_ints), dtype=np.int64)
    for c in range(plan.chunks):
        here = chunk == c
        pos = plan.hdr_ints
        for k in range(plan.bins):  # a bin's entries in pair order, then pads to a multiple of 4
            out[c, k] = pos - plan.hdr_ints
            mine = ent[here][bin_[here] == k]
            out[c, pos : pos + len(mine)] = mine
            pads = -len(mine) % 4
            out[c, pos + len(mine) : pos + len(mine) + pads] = (plan.spare_row + k % tcuda.SJLT_CLASSES) * tcuda.SJLT_BLOCK_COLS
            pos += len(mine) + pads
        out[c, plan.bins] = pos - plan.hdr_ints
    return out


LIST_SHAPES = [(1000, 200, 50), (3001, 2500, 251), (2000, 3100, 40), (300, 12_000, 9), (130, 97, 3)]


@pytest.mark.parametrize("s", S_VALUES)
@pytest.mark.parametrize("n,m,d", LIST_SHAPES)
def test_binned_list_is_the_references_pairs_in_bin_order(n, m, d, s):
    k0, k1 = 0x1234ABCD, 0x9E3779B9 ^ (n * 31 + m)
    key = torch.tensor([k0, k1], dtype=torch.int64)
    plan = tcuda.plan_sjlt(n, m, d, s)
    got = sref.bin_pairs(key, n, m, s, plan)
    assert got.shape == (plan.chunks, plan.region_ints)
    assert np.array_equal(got.numpy(), _reference_list(k0, k1, n, m, s, plan))


@pytest.mark.parametrize("s", S_VALUES)
@pytest.mark.parametrize("n,m,d", LIST_SHAPES)
def test_binned_list_adds_back_to_the_plain_sketch(n, m, d, s):
    key = torch.tensor([7, n + m + s], dtype=torch.int64)
    plan = tcuda.plan_sjlt(n, m, d, s)
    A = torch.from_numpy(np.random.default_rng(n + s).standard_normal((n, d)).astype(np.float32))
    got = sref.sketch_from_bins(sref.bin_pairs(key, n, m, s, plan), A, m, s, plan)
    want = sref.sketch(key, A, m, s)
    rms = want.double().pow(2).mean(0).sqrt().clamp_min(1e-30)
    assert float(((got.double() - want.double()).abs() / rms).max()) <= 1e-6
