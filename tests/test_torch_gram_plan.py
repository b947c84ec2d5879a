"""The dense sketch→Gram kernel's plan (``kernels/cuda.py`` ``plan_dense_gram``)
and its worker chunks, on the CPU, for each of the three families that share it
(Gaussian, Rademacher, SRHT): the plan is what keeps a worker's Gram bitwise the
same alone or among q, and what the kernel's C entry checks before it launches.
No card is needed."""
import pytest

from repro_torch.kernels import cuda as tcuda

# (n, m, d'): FIG3A's full n and m′ rows, m below one cluster, at a cluster
# boundary and one row either side (two and eight m-tiles), an odd number of
# m-tiles, d′ ∈ {1, 251, 256, 257} and past 256, n not a whole number of steps,
# n below one step.
SHAPES = [(500_000, 2500, 251), (25_000, 2500, 251), (1001, 40, 7), (3001, 127, 251), (3001, 128, 256),
          (3001, 129, 257), (3001, 511, 251), (3001, 512, 256), (3001, 513, 257), (33, 1, 1), (2000, 50, 9),
          (4097, 2500, 300), (5, 40, 3), (2**20, 64, 4), (777, 4224, 2049)]
DENSE = ["gaussian", "rademacher", "srht"]


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("family", DENSE)
def test_gram_plan_clusters_hold_at_most_eight_blocks_and_cover_m(family, n, m, d):
    plan = tcuda.plan_dense_gram(n, m, d)
    assert tcuda._splits(family, n, m, d, 0) == plan.n_splits  # every dense family runs this plan
    assert 1 <= plan.cluster <= tcuda.GRAM_MAX_CLUSTER <= 8  # the portable cluster size
    assert plan.m_tiles == -(-m // tcuda.GRAM_BLOCK_ROWS)
    assert plan.clusters * plan.cluster >= plan.m_tiles  # every m-tile has a block
    assert plan.clusters * plan.cluster - plan.m_tiles < plan.clusters  # padding < one block a cluster
    assert plan.grid_x == plan.d_tiles * plan.clusters * plan.cluster


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("family", DENSE)
def test_gram_plan_column_tiles_cover_d(family, n, m, d):
    plan = tcuda.plan_dense_gram(n, m, d)
    # The split X holds every column tile, for each dense family.
    assert tcuda.shared_scratch_bytes(family, n, m, d) == 4 * 2 * plan.d_tiles * plan.block_cols * plan.x_rows
    assert plan.block_cols in tcuda.GRAM_BLOCK_COLS
    assert (plan.d_tiles - 1) * plan.block_cols < d <= plan.d_tiles * plan.block_cols
    if d <= max(tcuda.GRAM_BLOCK_COLS):  # one column tile: each S entry drawn once per split
        assert plan.d_tiles == 1


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("family", DENSE)
def test_gram_plan_splits_are_whole_steps_and_cover_n(family, n, m, d):
    plan = tcuda.plan_dense_gram(n, m, d)
    assert tcuda._splits(family, n, m, d, 0) == plan.n_splits
    assert plan.rows_per_split % tcuda.STEP_ROWS == 0
    assert plan.rows_per_split % tcuda.GRAM_STEP_ROWS == 0
    assert (plan.n_splits - 1) * plan.rows_per_split < n <= plan.n_splits * plan.rows_per_split
    assert 1 <= plan.n_splits <= tcuda.MAX_GRID_Y
    # The split form of X holds every row the last split's steps read.
    assert plan.x_rows % tcuda.GRAM_STEP_ROWS == 0 and n <= plan.x_rows < n + tcuda.GRAM_STEP_ROWS
    assert plan.xs_floats == 2 * plan.d_tiles * plan.block_cols * plan.x_rows


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("family", DENSE)
def test_gram_plan_is_a_function_of_the_shapes_only(family, n, m, d, monkeypatch):
    plan = tcuda.plan_dense_gram(n, m, d)
    shared = tcuda.shared_scratch_bytes(family, n, m, d)
    tcuda.plan_dense_gram.cache_clear()
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", shared + (1 << 20))  # the chunk changes, the plan does not
    assert tcuda.plan_dense_gram(n, m, d) == plan
    tcuda.plan_dense_gram.cache_clear()
    assert tcuda._splits(family, n, m, d, 0) == plan.n_splits
    for q in (1, 2, 200):
        tcuda.worker_chunk(n, m, d, q, family=family)
        assert tcuda.plan_dense_gram(n, m, d) == plan


@pytest.mark.parametrize("n,m,d", SHAPES)
@pytest.mark.parametrize("q", [1, 8, 200])
@pytest.mark.parametrize("family", DENSE)
def test_gram_worker_chunk_fits_the_scratch_with_the_split_x(family, n, m, d, q):
    plan = tcuda.plan_dense_gram(n, m, d)
    chunk = tcuda.worker_chunk(n, m, d, q, family=family)
    assert 1 <= chunk <= q
    shared = tcuda.shared_scratch_bytes(family, n, m, d)
    assert shared == 4 * plan.xs_floats
    assert chunk == 1 or shared + chunk * 4 * plan.n_splits * m * d <= tcuda.SCRATCH_BYTES


@pytest.mark.parametrize("n,m,d", [(500_000, 2500, 251), (3001, 129, 257), (33, 1, 1)])
@pytest.mark.parametrize("family", DENSE)
def test_gram_worker_chunk_refuses_a_split_x_past_the_scratch(family, n, m, d, monkeypatch):
    """The split X is shared by every worker of a call and cannot be chunked:
    past SCRATCH_BYTES alone, the call is refused, not allocated past the budget.
    At the limit the chunk is one worker. The S·A and the SJLT Gram keep no split X."""
    shared = tcuda.shared_scratch_bytes(family, n, m, d)
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", shared - 1)
    with pytest.raises(ValueError, match="split X"):
        tcuda.worker_chunk(n, m, d, 8, family=family)
    assert tcuda.worker_chunk(n, m, d, 8, family=family, apply=True) >= 1
    assert tcuda.worker_chunk(n, m, d, 8, family="sjlt", s=20) >= 1
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", shared)
    assert tcuda.worker_chunk(n, m, d, 8, family=family) == 1


@pytest.mark.parametrize("family", DENSE)
def test_gram_worker_chunk_at_fig3a(family):
    """FIG3A (n = 500,000, d′ = 251, m = 2,500): one column tile, 40 m-tiles in
    clusters of two; the 1.02 GB split X and eight workers' partials fit the
    2 GiB scratch, so a q = 200 master solve makes 25 calls into the C entry."""
    n, m, d = 500_000, 2500, 251
    plan = tcuda.plan_dense_gram(n, m, d)
    assert (plan.block_cols, plan.d_tiles, plan.m_tiles) == (256, 1, 40)
    assert (plan.cluster, plan.clusters) == (2, 20)
    assert tcuda.shared_scratch_bytes(family, n, m, d) == 2 * 256 * 500_000 * 4
    chunk = tcuda.worker_chunk(n, m, d, 200, family=family)
    assert chunk == (tcuda.SCRATCH_BYTES - 2 * 256 * 500_000 * 4) // (4 * plan.n_splits * m * d)
    assert -(-200 // chunk) == 25


@pytest.mark.parametrize("family", ["rademacher", "srht", "sjlt"])
def test_other_families_share_no_scratch(family):
    """Every dense Gram (the Rademacher and the SRHT as the Gaussian) keeps the
    split form of X, shared by the workers of a call; the SJLT Gram and every
    S·A keep their partials alone."""
    want = 2 * 256 * 500_000 * 4 if family in tcuda.DENSE_GRAMS else 0
    assert tcuda.shared_scratch_bytes(family, 500_000, 2500, 251) == want
    assert tcuda.shared_scratch_bytes(family, 500_000, 2500, 251, apply=True) == 0
    assert tcuda.shared_scratch_bytes("gaussian", 500_000, 2500, 251, apply=True) == 0
