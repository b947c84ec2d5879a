"""The port's CUDA kernels on the card: odd shapes, chunking, and Algorithm 1.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when no CUDA
device is present (the CPU tests cover the plain versions). On a machine with a
card run them with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.

Gram kernel against plain version, per entry: max |ΔG_ij| / sqrt(G_ii·G_jj) ≤ 1e-5
over the plain G (float32 sums of ≤ 4096 terms in two orders). S·A kernel against
plain version, per column: max_i |ΔSX_ij| / rms_i(SX_ij) ≤ 1e-5. The FWHT kernel
is bitwise its plain version. Slices of a multi-key launch are bitwise equal to
single-key launches.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import distributed, operators, sketches
from repro_torch.kernels import common, cuda as tcuda
from repro_torch.kernels.fwht import ops as fops, ref as fref
from repro_torch.kernels.gaussian import ops as gops, ref as gref
from repro_torch.kernels.rademacher import ops as rops, ref as rref
from repro_torch.kernels.sjlt import ops as sops, ref as sref
from repro_torch.utils import prng

pytestmark = pytest.mark.gpu
REL_TOL = 1e-5
SJLT_S = 20


def _srht(fn):
    """An SRHT wrapper called as the dense ones are: (worker key(s), X, m)."""
    def call(keys, X, m):
        kd, rows = operators.srht_params(keys, m, sketches.next_pow2(X.shape[0]))
        return fn(kd, rows, X)

    return call


def _sjlt(fn, s=SJLT_S):
    return lambda keys, X, m: fn(keys, X, m, s)


# family -> (single, multi, plain multi, LAUNCHES, multi's counter name)
FAMILIES = {
    "gaussian": (gops.gaussian_gram, gops.gaussian_gram_multi, gref.gaussian_gram_multi,
                 gops.LAUNCHES, "gaussian_gram_multi"),
    "rademacher": (rops.rademacher_gram, rops.rademacher_gram_multi, rref.rademacher_gram_multi,
                   rops.LAUNCHES, "rademacher_gram_multi"),
    "srht": (_srht(fops.srht_gram), _srht(fops.srht_gram_multi), _srht(fref.srht_gram_multi),
             fops.LAUNCHES, "srht_gram_multi"),
    "sjlt": (_sjlt(sops.sjlt_gram), _sjlt(sops.sjlt_gram_multi), _sjlt(sref.sjlt_gram_multi),
             sops.LAUNCHES, "sjlt_gram_multi"),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _gram_err(G, want) -> float:
    G, want = G.double().reshape(-1, *G.shape[-2:]), want.double().reshape(-1, *want.shape[-2:])
    diag = torch.diagonal(want, dim1=-2, dim2=-1)
    return float(((G - want).abs() / (diag[:, :, None] * diag[:, None, :]).sqrt()).max())


def _x(n, d, seed, device):
    rs = np.random.default_rng(seed)
    return torch.from_numpy(rs.standard_normal((n, d)).astype(np.float32)).to(device)


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("n,d,m", [(1001, 7, 40), (3000, 300, 130), (33, 1, 1), (4096, 256, 64)])
def test_kernel_matches_plain_and_single_launches(cuda, family, n, d, m):
    single, multi, plain, *_ = FAMILIES[family]
    X = _x(n, d, n + d, cuda)
    keys = prng.worker_keys(prng.prng_key(n), 3)
    G = multi(keys, X, m)
    want = plain(keys, X, m)
    assert G.shape == (3, d, d)
    assert _gram_err(G, want) <= REL_TOL
    for w in range(3):
        assert torch.equal(G[w], single(keys[w], X, m))
    assert torch.equal(G, G.transpose(1, 2))
    assert torch.equal(multi(keys, X, m), G)


@pytest.mark.parametrize("s", [1, 4, 20])
@pytest.mark.parametrize("n,d,m", [(2000, 40, 3100), (777, 5, 1536), (1500, 33, 1537)])
def test_sjlt_beyond_one_shared_tile_and_any_s(cuda, s, n, d, m):
    """m larger than one block's shared accumulator is cut into m-tiles."""
    X = _x(n, d, s + m, cuda)
    keys = prng.worker_keys(prng.prng_key(m), 2)
    G = sops.sjlt_gram_multi(keys, X, m, s)
    assert _gram_err(G, sref.sjlt_gram_multi(keys, X, m, s)) <= REL_TOL
    assert torch.equal(G[1], sops.sjlt_gram(keys[1], X, m, s))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_q_chunking_is_bitwise_invisible(cuda, family, monkeypatch):
    _, multi, _, launches, name = FAMILIES[family]
    X = _x(2000, 9, 1, cuda)
    keys = prng.worker_keys(prng.prng_key(2), 5)
    whole = multi(keys, X, 50)
    s = SJLT_S if family == "sjlt" else 0
    chunks = tcuda._splits(family, 2000, 50, 9, s)
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 2 * 4 * chunks * 50 * 9)
    assert tcuda.worker_chunk(2000, 50, 9, 5, family=family, s=s) == 2
    before = launches[name]
    assert torch.equal(multi(keys, X, 50), whole)
    assert launches[name] == before + 3  # one per chunk of workers: 2 + 2 + 1


def test_launch_counters_count_kernel_launches(cuda):
    X = _x(500, 4, 3, cuda)
    keys = prng.worker_keys(prng.prng_key(4), 2)
    for single, multi, _, launches, name in FAMILIES.values():
        single_name = name.removesuffix("_multi")
        before = launches[single_name], launches[name]
        single(keys[0], X, 16)
        multi(keys, X, 16)
        assert (launches[single_name], launches[name]) == (before[0] + 1, before[1] + 1)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="float32"):
        gops.gaussian_gram(key, _x(64, 4, 0, cuda).double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        gops.gaussian_gram(key, _x(64, 4, 0, cuda).T, 8)
    with pytest.raises(ValueError, match="srht_rows"):
        tcuda.sketch_gram("srht", key.reshape(1, 2), _x(64, 4, 0, cuda), 8, rounds=20,
                          launches=fops.LAUNCHES, name="srht_gram")
    with pytest.raises(ValueError, match="s="):
        sops.sjlt_gram(key, _x(64, 4, 0, cuda), 8, tcuda.SJLT_MAX_PAIRS + 1)


@pytest.mark.parametrize("rounds", [20, 8, 12])
def test_rng_probe_matches_plain_contract(cuda, rounds):
    rs = np.random.default_rng(rounds)
    c0 = torch.from_numpy(rs.integers(0, 2**32, 4096).astype(np.int64))
    c1 = torch.from_numpy(rs.integers(0, 2**32, 4096).astype(np.int64))
    words, normals, signs = tcuda.rng_probe(7, 2**32 - 7, c0, c1, rounds=rounds)
    w0, w1 = common.threefry2x32(7, 2**32 - 7, c0, c1, rounds=rounds)
    assert torch.equal(words.cpu(), torch.stack([w0, w1], dim=1))
    z = common.counter_normal(7, 2**32 - 7, c0, c1, rounds=rounds)
    assert float((normals.cpu() - z).abs().max()) <= 2e-6
    s = common.unpack_signs(common.packed_sign_words(7, 2**32 - 7, c0, c1 // 32), c1 % 32)
    assert torch.equal(signs.cpu(), s)


def test_rng_rounds_knob_reaches_the_kernel(cuda, monkeypatch):
    X = _x(700, 5, 9, cuda)
    key = prng.prng_key(1)
    monkeypatch.setenv("REPRO_RNG_ROUNDS", "12")
    G = gops.gaussian_gram(key, X, 24)
    want = gref.gaussian_gram(key, X, 24)
    assert _gram_err(G, want) <= REL_TOL


@pytest.mark.parametrize("kind", ["gaussian", "rademacher", "srht", "sjlt"])
def test_algorithm1_on_the_card_matches_the_cpu(cuda, kind):
    rs = np.random.default_rng(5)
    A = torch.from_numpy(rs.standard_normal((3000, 12)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal(3000).astype(np.float32))
    spec = sketches.SketchSpec(kind, 80, s=SJLT_S, use_kernel=True)
    key = prng.prng_key(6)
    mask = np.array([1, 1, 0, 1], np.float32)
    for entry in (distributed.distributed_sketch_solve, distributed.distributed_sketch_solve_master):
        got = entry(spec, key, A, b, q=4, straggler_mask=mask)
        want = entry(spec, key, A, b, q=4, straggler_mask=mask, device="cpu")
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


# ------------------------------------------------------------ S·A and FWHT kernels

def _sx_err(SX, want) -> float:
    """max over columns of max_i |ΔSX_ij| / rms_i(SX_ij), over a stack of sketches."""
    SX, want = SX.double().reshape(-1, *SX.shape[-2:]), want.double().reshape(-1, *want.shape[-2:])
    rms = want.pow(2).mean(dim=-2, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((SX - want).abs() / rms).max())


# family -> (single apply, multi apply, plain multi, LAUNCHES, multi's counter name)
APPLIES = {
    "gaussian": (gops.gaussian_sketch, gops.gaussian_sketch_multi, gref.sketch_multi,
                 gops.LAUNCHES, "gaussian_sketch_multi"),
    "rademacher": (rops.rademacher_sketch, rops.rademacher_sketch_multi, rref.sketch_multi,
                   rops.LAUNCHES, "rademacher_sketch_multi"),
    "sjlt": (_sjlt(sops.sjlt_apply), _sjlt(sops.sjlt_apply_multi), _sjlt(sref.sketch_multi),
             sops.LAUNCHES, "sjlt_apply_multi"),
}


@pytest.mark.parametrize("family", list(APPLIES))
@pytest.mark.parametrize("n,d,m", [(1001, 7, 40), (3000, 251, 130), (2999, 300, 64), (33, 1, 1),
                                   (50, 5, 200), (25_000, 251, 2500)])
def test_apply_kernel_matches_plain_and_single_launches(cuda, family, n, d, m):
    """Ragged n, d′ = 1, 251 and 300 (two dense column tiles), m = 1 and m > n;
    per column max |ΔSX_ij| / rms_i(SX_ij) ≤ 1e-5; q-key slices bitwise single calls."""
    single, multi, plain, *_ = APPLIES[family]
    X = _x(n, d, n + 3 * d, cuda)
    keys = prng.worker_keys(prng.prng_key(n + m), 3)
    SX = multi(keys, X, m)
    assert SX.shape == (3, m, d)
    assert _sx_err(SX, plain(keys, X, m)) <= REL_TOL
    for w in range(3):
        assert torch.equal(SX[w], single(keys[w], X, m))
    assert torch.equal(multi(keys, X, m), SX)


@pytest.mark.parametrize("family", ["gaussian", "rademacher", "sjlt"])
def test_apply_is_bitwise_the_sketch_the_gram_kernel_contracts(cuda, family):
    """The fused Gram kernel's G is bitwise the Gram pass's fmaf chain (over m,
    ascending, from 0) on the S·A kernel's S·X: the two share the sketch pass,
    the plan and the split reduction. fmaf is taken as one rounding of the exact
    float64 product-sum (a double rounding could differ in about 1 of 2**29 steps)."""
    single_gram = FAMILIES[family][0]
    single_apply = APPLIES[family][0]
    X = _x(4000, 19, 7, cuda)
    key = prng.prng_key(8)
    SX = single_apply(key, X, 96).double()
    G = torch.zeros((19, 19), dtype=torch.float32, device=cuda)
    for r in range(SX.shape[0]):
        G = (G.double() + SX[r][:, None] * SX[r][None, :]).float()
    assert torch.equal(single_gram(key, X, 96), G)


@pytest.mark.parametrize("family", list(APPLIES))
def test_apply_q_chunking_is_bitwise_invisible(cuda, family, monkeypatch):
    _, multi, _, launches, name = APPLIES[family]
    X = _x(2000, 9, 1, cuda)
    keys = prng.worker_keys(prng.prng_key(2), 5)
    whole = multi(keys, X, 50)
    s = SJLT_S if family == "sjlt" else 0
    chunks = tcuda._splits(family, 2000, 50, 9, s)
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 2 * 4 * chunks * 50 * 9)
    before = launches[name]
    assert torch.equal(multi(keys, X, 50), whole)
    assert launches[name] == before + 3  # one per chunk of workers: 2 + 2 + 1


@pytest.mark.parametrize("log_n", list(range(0, 21)))
@pytest.mark.parametrize("k", [1, 251])
def test_fwht_kernel_is_bitwise_the_plain_version(cuda, log_n, k):
    """n_pad = 1 to 2**20, across every pass boundary (passes of ≤ 10 stages)."""
    if k == 251 and log_n > 19:
        k = 33
    x = _x(1 << log_n, k, log_n, cuda)
    before = fops.LAUNCHES["fwht"]
    y = fops.fwht(x)
    assert fops.LAUNCHES["fwht"] == before + 1
    assert torch.equal(y, fref.fwht(x))
    assert torch.equal(fops.fwht(x), y)


def test_apply_and_fwht_wrappers_reject_what_the_kernels_do_not_take(cuda):
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="float32"):
        gops.gaussian_sketch(key, _x(64, 4, 0, cuda).double(), 8)
    with pytest.raises(ValueError, match="contiguous"):
        sops.sjlt_apply(key, _x(64, 4, 0, cuda).T, 8, 4)
    with pytest.raises(ValueError, match="gaussian and rademacher"):
        tcuda.sketch_apply("srht", key.reshape(1, 2), _x(64, 4, 0, cuda), 8, rounds=20,
                           launches=fops.LAUNCHES, name="x")
    with pytest.raises(ValueError, match="power-of-two"):
        fops.fwht(_x(48, 4, 0, cuda))
    with pytest.raises(ValueError, match="contiguous"):
        fops.fwht(_x(4, 64, 0, cuda).T)


def test_apply_launch_counters_count_kernel_launches(cuda):
    X = _x(500, 4, 3, cuda)
    keys = prng.worker_keys(prng.prng_key(4), 2)
    for single, multi, _, launches, name in APPLIES.values():
        single_name = name.removesuffix("_multi")
        before = launches[single_name], launches[name]
        single(keys[0], X, 16)
        multi(keys, X, 16)
        assert (launches[single_name], launches[name]) == (before[0] + 1, before[1] + 1)


NEW_KINDS = ["uniform", "uniform_norep", "leverage", "hybrid_gaussian", "hybrid_rademacher",
             "hybrid_sjlt", "hybrid_srht"]


@pytest.mark.parametrize("kind", NEW_KINDS + ["qr_gaussian", "qr_rademacher", "qr_srht", "qr_sjlt"])
def test_new_paths_on_the_card_match_the_cpu(cuda, kind):
    """Both entry points with each sampling kind, every hybrid inner kind, and
    ``method="qr"`` for the four projections, on the card against the CPU."""
    rs = np.random.default_rng(9)
    A = torch.from_numpy(rs.standard_normal((3000, 12)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal(3000).astype(np.float32))
    method = "qr" if kind.startswith("qr_") else "fused"
    if kind.startswith("qr_"):
        spec = sketches.SketchSpec(kind[3:], 80, s=SJLT_S, use_kernel=True)
    elif kind.startswith("hybrid_"):
        spec = sketches.SketchSpec("hybrid", 80, m_prime=800, inner=kind[7:], s=SJLT_S, use_kernel=True)
    elif kind == "uniform_norep":
        spec = sketches.SketchSpec("uniform", 80, replacement=False)
    else:
        spec = sketches.SketchSpec(kind, 80)
    key = prng.prng_key(10)
    for entry in (distributed.distributed_sketch_solve, distributed.distributed_sketch_solve_master):
        got = entry(spec, key, A, b, q=4, method=method)
        want = entry(spec, key, A, b, q=4, method=method, device="cpu")
        assert got.device.type == "cuda"
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)


def test_row_draws_on_the_card_are_bitwise_the_cpu_draws(cuda):
    key = prng.prng_key(11)
    assert torch.equal(prng.gumbel_top_k(key, 500_000, 25_000, device=cuda).cpu(),
                       prng.gumbel_top_k(key, 500_000, 25_000))
    logits = prng.xla_log(torch.rand(5000, generator=torch.Generator().manual_seed(0)) + 1e-30)
    assert torch.equal(prng.categorical(key, logits.to(cuda), 300).cpu(), prng.categorical(key, logits, 300))
    assert torch.equal(prng.gumbel(key, (64, 99), device=cuda).cpu(), prng.gumbel(key, (64, 99)))


# ------------------------------------------------ Gaussian adjoint and least norm


@pytest.mark.parametrize("m,n,k", [(200, 1000, 1), (200, 500, 1), (1, 1, 1), (63, 129, 1), (64, 300, 1),
                                   (65, 1001, 3), (129, 257, 8), (300, 1001, 33), (4000, 8000, 1)])
def test_adjoint_kernel_matches_plain(cuda, m, n, k):
    """m across split and chunk edges, ragged n, k = 1, 3, 8 and 33 (column tiles
    of 8): per column max_i |Δ(SᵀY)_ij| / rms_i ≤ 1e-5 against the float64 plain
    version; a rerun is bitwise equal; one launch per call."""
    Y = _x(m, k, m + n + k, cuda)
    key = prng.prng_key(m * n + k)
    before = gops.LAUNCHES["gaussian_adjoint"]
    out = gops.gaussian_adjoint(key, Y, n)
    assert gops.LAUNCHES["gaussian_adjoint"] == before + 1
    assert out.shape == (n, k)
    assert _sx_err(out, gref.adjoint(key, Y, n)) <= REL_TOL
    assert torch.equal(gops.gaussian_adjoint(key, Y, n), out)


@pytest.mark.parametrize("m,n", [(200, 1000), (4000, 11_556)])
def test_adjoint_kernel_is_the_transpose_of_the_apply_kernel(cuda, m, n):
    """⟨S·x, y⟩ = ⟨x, Sᵀ·y⟩ with S·x from the Gaussian S·A kernel."""
    x, y = _x(n, 1, 1, cuda), _x(m, 1, 2, cuda)
    key = prng.prng_key(n)
    Sx, Sty = gops.gaussian_sketch(key, x, m), gops.gaussian_adjoint(key, y, n)
    lhs, rhs = float(Sx.double().T @ y.double()), float(x.double().T @ Sty.double())
    assert abs(lhs - rhs) <= REL_TOL * float(Sx.norm() * y.norm() + x.norm() * Sty.norm())


def test_adjoint_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    key = prng.prng_key(0)
    with pytest.raises(ValueError, match="float32"):
        gops.gaussian_adjoint(key, _x(64, 2, 0, cuda).double(), 10)
    with pytest.raises(ValueError, match="contiguous"):
        gops.gaussian_adjoint(key, _x(2, 64, 0, cuda).T, 10)


@pytest.mark.parametrize("log_n", [10, 13, 14])
@pytest.mark.parametrize("k", [1, 33])
def test_fwht_kernel_on_the_srht_adjoint_shapes(cuda, log_n, k):
    """The SRHT adjoint's FWHT of a scattered vector: n_pad = 2^10 (FIG4A's d) and
    2^13, 2^14 (the Fig. 4(b) hybrid's m′ and its d), k = 1 and 33, bitwise."""
    x = torch.zeros((1 << log_n, k), device=cuda)
    rows = torch.randint(0, 1 << log_n, (500,), generator=torch.Generator().manual_seed(log_n))
    x[rows.to(cuda)] = _x(500, k, k, cuda)
    assert torch.equal(fops.fwht(x), fref.fwht(x))


@pytest.mark.parametrize("k", [None, 3])
def test_scatter_of_repeated_rows_is_bitwise_the_cpu_scatter(cuda, k):
    rs = np.random.default_rng(12)
    rows = torch.from_numpy(rs.integers(0, 300, 4000))
    Y = torch.from_numpy(rs.standard_normal((4000,) if k is None else (4000, k)).astype(np.float32))
    got = operators._scatter_rows(rows.to(cuda), Y.to(cuda), 300)
    assert torch.equal(operators._scatter_rows(rows.to(cuda), Y.to(cuda), 300), got)
    assert torch.equal(got.cpu(), operators._scatter_rows(rows, Y, 300))


@pytest.mark.parametrize("out", [False, True])
def test_sjlt_plain_segment_sum_is_bitwise_the_cpu_sum(cuda, out):
    """The SJLT's plain S·A (the operator's path without the kernel) adds each
    sketch row's pairs in a fixed order on the card: bitwise run to run and the CPU."""
    rs = np.random.default_rng(15)
    A = torch.from_numpy(rs.standard_normal((3000, 7)).astype(np.float32))
    buckets, signs = common.sjlt_counter_params(11, 12, torch.arange(3000), SJLT_S, 90)
    acc = torch.from_numpy(rs.standard_normal((90, 7)).astype(np.float32)) if out else None

    def run(dev):
        return sref.sjlt_apply(A.to(dev), buckets.to(dev), signs.to(dev), 90,
                               out=None if acc is None else acc.to(dev))

    got = run(cuda)
    assert torch.equal(run(cuda), got)
    assert torch.equal(got.cpu(), run("cpu"))


LEAST_NORM_KINDS = ["gaussian", "rademacher", "srht", "sjlt", "uniform", "uniform_norep", "leverage",
                    "hybrid_gaussian", "hybrid_rademacher", "hybrid_sjlt", "hybrid_srht"]


@pytest.mark.parametrize("kind", LEAST_NORM_KINDS)
def test_least_norm_on_the_card_matches_the_cpu(cuda, kind):
    """``distributed_sketch_least_norm`` with every kind (the S·A, FWHT and adjoint
    kernels with ``use_kernel``) on the card against the CPU, and bitwise reruns."""
    rs = np.random.default_rng(13)
    A = torch.from_numpy(rs.standard_normal((30, 1500)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal(30).astype(np.float32))
    if kind.startswith("hybrid_"):
        spec = sketches.SketchSpec("hybrid", 120, m_prime=400, inner=kind[7:], s=SJLT_S, use_kernel=True)
    elif kind == "uniform_norep":
        spec = sketches.SketchSpec("uniform", 120, replacement=False)
    else:
        spec = sketches.SketchSpec(kind, 120, s=SJLT_S, use_kernel=True)
    key = prng.prng_key(14)
    mask = np.array([1, 1, 0, 1], np.float32)
    got = distributed.distributed_sketch_least_norm(spec, key, A, b, q=4, straggler_mask=mask)
    want = distributed.distributed_sketch_least_norm(spec, key, A, b, q=4, straggler_mask=mask, device="cpu")
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(distributed.distributed_sketch_least_norm(spec, key, A, b, q=4, straggler_mask=mask), got)
