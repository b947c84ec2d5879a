"""The dense S·A kernel's plan and the numeric premise of its 3xTF32 product, on the CPU.

``plan_apply`` is plain Python: it must cover n in whole 32-row steps, depend on
the shapes only, spread FIG4A's small shapes over many blocks, form clusters of
at most 8 blocks that divide the grid's x extent, and keep the partials within
the scratch. The kernel itself runs only on the card (``tests/test_torch_cuda.py``).

The premise: with TF32 rounding (round to nearest, ties away, on the 13 dropped
mantissa bits) emulated here, the three products lo·hi + hi·lo + hi·hi of the
plain version's float32 S and X (two, s·x_lo + s·x_hi with the scale after, for
the ±1 signs) land within 1e-6 per column (of the column's rms) of the float64
product, and one TF32 product does not come near: the split is what makes the
tensor cores fp32-accurate. The sums are taken in float64 here; the kernel's own
fp32 accumulation is held to 1e-5 on the card. The ±1 Gram kernel's premise
is taken in float32 as that kernel sums: chains of one 32-row step of
S·X_lo + S·X_hi, running sums over a FIG3A split, the scale 1/√m after, within
1e-5 per entry of the column's rms, with the SRHT's signs drawn as the kernel
draws them (one word per sketch row and step).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import operators
from repro_torch.kernels import common, cuda as tcuda
from repro_torch.kernels.fwht import ref as fref
from repro_torch.kernels.gaussian import ref as gref
from repro_torch.kernels.rademacher import ref as rref
from repro_torch.utils import prng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

FIG4A_SHAPES = [(1000, 200, 50), (500, 200, 50)]  # X = Aᵀ and the hybrid's m′ rows: (n, m, d)
SHAPES = FIG4A_SHAPES + [(11_556, 4000, 2000), (8000, 4000, 2000), (25_000, 2500, 251),
                         (500_000, 2500, 251), (2000, 130, 2049), (1000, 4224, 2048), (33, 1, 1),
                         (3000, 130, 300), (50, 200, 5), (2**20, 64, 4), (1, 1, 1)]


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_plan_apply_covers_n_and_fits_the_kernel(n, m, d):
    plan = tcuda.plan_apply(n, m, d)
    assert plan.rows_per_split % tcuda.STEP_ROWS == 0
    assert (plan.n_splits - 1) * plan.rows_per_split < n <= plan.n_splits * plan.rows_per_split
    assert plan.block_cols in tcuda.APPLY_BLOCK_COLS and plan.block_rows == tcuda.APPLY_BLOCK_ROWS
    tiles = -(-d // plan.block_cols)
    # Clusters: at most 8 blocks, a whole number of them along grid x, and every
    # column tile in one, fewer dead tiles than a cluster holds.
    assert 1 <= plan.cluster <= tcuda.APPLY_MAX_CLUSTER
    assert plan.grid_x % plan.cluster == 0
    assert plan.grid_x == -(-m // plan.block_rows) * plan.groups * plan.cluster
    assert tiles <= plan.groups * plan.cluster < tiles + plan.groups
    assert plan.groups == -(-tiles // tcuda.APPLY_MAX_CLUSTER)
    assert plan.n_splits <= tcuda.MAX_GRID_Y
    assert plan.direct == (plan.n_splits == 1)
    # The partials of one call stay within the scratch at q = 200.
    chunk = tcuda.worker_chunk(n, m, d, 200, apply=True)
    assert chunk == 1 or plan.direct or chunk * 4 * plan.n_splits * m * d <= tcuda.SCRATCH_BYTES


@pytest.mark.parametrize("n,m,d", FIG4A_SHAPES)
def test_plan_apply_spreads_fig4a_over_many_blocks(n, m, d):
    """FIG4A's S·Aᵀ shapes launched 8 and 4 blocks on the Gram's plan; the S·A plan
    launches at least 64, in splits of far fewer than 16 steps."""
    plan = tcuda.plan_apply(n, m, d)
    assert plan.blocks >= 64
    assert plan.rows_per_split // tcuda.STEP_ROWS < tcuda.MIN_SPLIT_STEPS
    assert plan.block_cols == 64 and plan.cluster == 1


@pytest.mark.parametrize("n,m,d,cluster", [(11_556, 4000, 2000, 8), (8000, 4000, 2000, 8), (2000, 130, 2049, 5)])
def test_plan_apply_draws_s_once_per_group_of_eight_tiles(n, m, d, cluster):
    plan = tcuda.plan_apply(n, m, d)
    assert plan.block_cols == 256 and plan.cluster == cluster


def test_plan_apply_is_a_function_of_the_shapes_only(monkeypatch):
    plan = tcuda.plan_apply(11_556, 4000, 2000)
    assert tcuda.plan_apply(11_556, 4000, 2000) == plan
    assert tcuda.worker_chunk(11_556, 4000, 2000, 3, apply=True) == 3
    # One split keeps no partials: any q goes in one call.
    assert tcuda.plan_apply(1000, 4224, 2048).direct
    assert tcuda.worker_chunk(1000, 4224, 2048, 5000, apply=True) == 5000
    # A smaller scratch is seen (the plan is cached per scratch size too).
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 4 * 4000 * 2000)
    assert tcuda.plan_apply(11_556, 4000, 2000).n_splits == 1


def test_key_words_keep_their_bits_on_the_host():
    words = torch.tensor([[0, 2**31 - 1], [2**31, 2**32 - 1]], dtype=torch.int64)
    got = tcuda._u32_words(words, torch.device("cpu"))
    assert got.dtype == torch.int32
    assert torch.equal(got.to(torch.int64) & common.MASK32, words)


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    log = """ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    40 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 128 registers, used 2 barriers, 40 bytes cumulative stack size
ptxas info    : Compiling entry function '_Z3barv' for 'sm_90a'
ptxas info    : Function properties for _Z3barv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers
"""
    rows = tcuda.ptxas_usage(log)
    assert [r["kernel"] for r in rows] in (["foo", "bar"], ["_Z3fooPf", "_Z3barv"])  # c++filt or not
    assert [(r["registers"], r["stack"], r["spill_stores"], r["spill_loads"]) for r in rows] == [
        (128, 40, 4, 8), (32, 0, 0, 0)]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to TF32 (10 explicit mantissa bits): round to
    nearest, ties away from zero, as ``cvt.rna.tf32.f32``."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32(x)
    return hi, tf32(x - hi)


def col_err(got: torch.Tensor, want: torch.Tensor) -> float:
    rms = want.pow(2).mean(dim=0, keepdim=True).sqrt().clamp_min(1e-300)
    return float(((got - want).abs() / rms).max())


def test_tf32_rounding_is_round_to_nearest_away():
    one = torch.tensor([1.0], dtype=torch.float32)
    ulp = 2.0**-10
    x = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2**-23, -(1 + ulp / 2), 1 + ulp], dtype=torch.float32)
    assert tf32(x).tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + ulp]
    assert tf32(one).item() == 1.0


@pytest.mark.parametrize("n,m,d", [(1000, 200, 50), (2048, 128, 300)])
def test_3xtf32_of_the_plain_s_is_fp32_accurate(n, m, d):
    rs = np.random.default_rng(n + d)
    X = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32))
    key = prng.prng_key(n)
    # Gaussian: S (float32, scale inside) split like X; three products.
    S = gref.sketch_matrix(key, m, n)
    exact = S.double() @ X.double()
    (sh, sl), (xh, xl) = split(S), split(X)
    three = sl.double() @ xh.double() + sh.double() @ xl.double() + sh.double() @ xh.double()
    one = sh.double() @ xh.double()
    assert col_err(three, exact) <= 1e-6
    assert col_err(one, exact) > 1e-4
    # Rademacher: S = ±1 exactly in TF32, two products, the scale after.
    signs = rref.sketch_matrix(key, m, n) * np.sqrt(m)
    signs = torch.sign(signs)
    assert torch.equal(tf32(signs), signs)
    scale = common.inv_sqrt(m)
    exact = rref.sketch_matrix(key, m, n).double() @ X.double()
    two = (signs.double() @ xl.double() + signs.double() @ xh.double()) * scale
    assert col_err(two, exact) <= 1e-6
    assert col_err((signs.double() @ xh.double()) * scale, exact) > 1e-4


def _kernel_chain_sum(signs: torch.Tensor, X: torch.Tensor, scale: float, chain_rows: int = 32) -> torch.Tensor:
    """The ±1 Gram kernel's S·X over one split, emulated in float32: per 8-row
    k-slice the products with X_lo, then with X_hi, summed in order into a chain
    of ``chain_rows`` data rows (the tensor cores' accumulator; each ±1·tf32
    product is exact), each chain added to a running sum, the scale applied once
    at the end."""
    m, n = signs.shape
    xh, xl = split(X)
    steps = n // chain_rows
    s = signs.reshape(m, steps, chain_rows // 8, 8).permute(1, 2, 3, 0)  # (chain, slice, row, m)
    parts = [xl.reshape(steps, chain_rows // 8, 8, -1), xh.reshape(steps, chain_rows // 8, 8, -1)]
    acc = torch.zeros((steps, m, X.shape[1]), dtype=torch.float32)
    for ks in range(chain_rows // 8):
        for part in parts:
            for r in range(8):
                acc = acc + s[:, ks, r, :, None] * part[:, ks, r, None, :]
    run = torch.zeros((m, X.shape[1]), dtype=torch.float32)
    for c in range(steps):
        run = run + acc[c]
    return run * torch.tensor(scale, dtype=torch.float32)


def _srht_kernel_signs(kd: torch.Tensor, ids: torch.Tensor, j_begin: int, n: int) -> torch.Tensor:
    """(m, n) ±1 signs of the SRHT's data rows j_begin .. j_begin + n − 1 drawn as
    the kernel draws them: per step of 32 rows starting at j0, the word of sketch
    row r is H_r ^ D ^ −parity(id_r & j0), with H_r's bit k the parity of id_r & k
    (k < 32) and D's bit k the diagonal's sign bit at j0 + k."""
    ids = ids.to(torch.int64)
    k = torch.arange(32, dtype=torch.int64)
    h = fref.parity(ids[:, None] & k[None, :])  # (m, 32)
    j0 = j_begin + 32 * torch.arange(n // 32, dtype=torch.int64)  # (steps,)
    d_bits = (fref.diagonal(*common.key_words(kd), j0[:, None] + k[None, :]) < 0).to(torch.int64)  # (steps, 32)
    step_parity = fref.parity(ids[:, None] & j0[None, :])  # (m, steps)
    bits = h[:, None, :] ^ d_bits[None, :, :] ^ step_parity[:, :, None]  # (m, steps, 32)
    return (1 - 2 * bits).reshape(ids.shape[0], n).to(torch.float32)


@pytest.mark.parametrize("family", ["rademacher", "srht"])
def test_pm1_two_tf32_products_in_kernel_chains_are_fp32_accurate(family):
    """The ±1 Gram kernel's premise at FIG3A's split length (the plan's
    rows_per_split, 9,632 rows, the tenth split) for one 64-row m-tile with
    FIG3A's scale 1/√2,500: signs drawn as the kernel draws them (the SRHT's from
    one word per row and step, equal bitwise to the closed form), X split into
    TF32 hi and lo, S·X_lo + S·X_hi in float32 chains of one 32-row step, then
    running sums, then the scale: within 1e-5 per entry of the column's rms of
    the float64 S·X (the Gram checks hold G to 1e-5 per entry), and one TF32
    product (X_hi alone) is not."""
    plan = tcuda.plan_dense_gram(500_000, 2500, 251)
    n, m, d = plan.rows_per_split, 64, 16
    j_begin = 10 * plan.rows_per_split
    scale = common.inv_sqrt(2500)
    rs = np.random.default_rng(17)
    X = torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32))
    key = prng.prng_key(17)
    if family == "rademacher":
        signs = torch.sign(rref.columns(*common.key_words(key), m, j_begin, n))
    else:
        kd, ids = operators.srht_params(key, m, 2**19)
        signs = _srht_kernel_signs(kd, ids, j_begin, n)
        closed = fref.columns(*common.key_words(kd), ids, j_begin, n)
        assert torch.equal(signs, torch.sign(closed))  # the word draw is the closed form, bitwise
    assert torch.equal(tf32(signs), signs)
    exact = (signs.double() * scale) @ X.double()
    assert col_err(_kernel_chain_sum(signs, X, scale), exact) <= 1e-5
    one = (signs.double() @ split(X)[0].double()) * scale
    assert col_err(one, exact) > 1e-4
