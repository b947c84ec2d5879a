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
import dataclasses

import numpy as np
import pytest
import torch

import _sjlt_fixed_point as fixed
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


def _sx_err(SX, want) -> float:
    SX, want = SX.double(), want.double()
    rms = want.pow(2).mean(dim=-2, keepdim=True).sqrt().clamp_min(1e-30)
    return float(((SX - want).abs() / rms).max())


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


# (n, d', m) at the edges of the SJLT plan (cuda.plan_sjlt): FIG4A's Aᵀ and
# hybrid rows (one-chunk splits), m past one m-tile (2,500, 3,100 and 12,000
# sketch rows), d′ not a multiple of the 32-column tile, n not a multiple of a
# chunk, n below one chunk.
SJLT_EDGES = [(1000, 50, 200), (500, 50, 200), (3001, 251, 2500), (2000, 40, 3100), (300, 9, 12_000),
              (1001, 7, 40), (777, 5, 1536), (33, 1, 1)]


@pytest.mark.parametrize("s", [1, 4, 20, tcuda.SJLT_MAX_PAIRS])
@pytest.mark.parametrize("n,d,m", SJLT_EDGES)
def test_sjlt_at_the_plan_edges(cuda, n, d, m, s):
    """The SJLT Gram and S·A against their plain versions (1e-5 per entry, per
    column), q-key slices bitwise single-key calls, reruns bitwise, and no call
    that waits for the card."""
    X = _x(n, d, n + m + s, cuda)
    keys = prng.worker_keys(prng.prng_key(n + d + m + s), 3)
    G, again = _runs_without_sync(lambda: sops.sjlt_gram_multi(keys, X, m, s))
    assert torch.equal(G, again)
    assert _gram_err(G, sref.sjlt_gram_multi(keys, X, m, s)) <= REL_TOL
    SX = sops.sjlt_apply_multi(keys, X, m, s)
    assert _sx_err(SX, sref.sketch_multi(keys, X, m, s)) <= REL_TOL
    assert torch.equal(sops.sjlt_apply_multi(keys, X, m, s), SX)
    for w in range(3):
        assert torch.equal(G[w], sops.sjlt_gram(keys[w], X, m, s))
        assert torch.equal(SX[w], sops.sjlt_apply(keys[w], X, m, s))


@pytest.mark.parametrize("s", [1, 20])
@pytest.mark.parametrize("n,d,m", [(1000, 50, 200), (3001, 251, 2500), (300, 9, 12_000), (1001, 7, 40)])
def test_sjlt_bin_pass_is_bitwise_its_plain_version(cuda, n, d, m, s):
    """The binned pair list the card writes (bin offsets, entries, zeros) is the
    plain twin's (``sjlt.ref.bin_pairs``) word for word, for each worker."""
    keys = prng.worker_keys(prng.prng_key(n + m), 2)
    plan = tcuda.plan_sjlt(n, m, d, s)
    got = tcuda.sjlt_bins(keys, n, m, d, s).cpu().to(torch.int64) & common.MASK32
    for w in range(2):
        assert torch.equal(got[w], sref.bin_pairs(keys[w], n, m, s, plan))


@pytest.mark.parametrize("entry", ["repro_sjlt_gram", "repro_sjlt_apply"])
def test_sjlt_chunk_edges_are_single_key_calls(cuda, entry, monkeypatch):
    """q past worker_chunk: the slices on either side of each chunk edge are
    bitwise single-key calls, each chunk is one call into the C entry, and a
    rerun is bitwise."""
    n, d, m = 3001, 251, 2500
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 3 * tcuda.worker_scratch_bytes("sjlt", n, m, d, SJLT_S))
    assert tcuda.worker_chunk(n, m, d, 7, family="sjlt", s=SJLT_S) == 3
    single, multi, name = ((sops.sjlt_gram, sops.sjlt_gram_multi, "sjlt_gram_multi") if entry == "repro_sjlt_gram"
                           else (sops.sjlt_apply, sops.sjlt_apply_multi, "sjlt_apply_multi"))
    X = _x(n, d, 9, cuda)
    keys = prng.worker_keys(prng.prng_key(10), 7)
    before = sops.LAUNCHES[name]
    out = multi(keys, X, m, SJLT_S)
    assert sops.LAUNCHES[name] == before + 3  # 3 + 3 + 1
    assert torch.equal(multi(keys, X, m, SJLT_S), out)
    for w in (0, 2, 3, 5, 6):
        assert torch.equal(out[w], single(keys[w], X, m, SJLT_S))


def test_sjlt_entries_refuse_plans_they_cannot_take(cuda):
    """The C entries check the plan and return cudaErrorInvalidValue (1) before
    launching anything: a chunk past 64 rows or 2,048 pairs, splits that are not
    whole chunks, that leave rows out or leave a split empty, an m-tile of no
    rows, one whose accumulator an entry cannot address or shared memory cannot
    hold, more bins than the list's header takes."""
    lib = tcuda._library("sjlt_gram")
    n, d, m, s = 1000, 50, 200, 20
    plan = tcuda.plan_sjlt(n, m, d, s)
    X = _x(n, d, 0, cuda)
    kw = tcuda._u32_words(prng.worker_keys(prng.prng_key(0), 1), cuda)
    pairs = torch.empty(plan.list_ints, dtype=torch.int32, device=cuda)
    partial = torch.empty(64 * m * d, dtype=torch.float32, device=cuda)
    G = torch.empty((d, d), dtype=torch.float32, device=cuda)
    good = dict(rows=plan.rows_per_split, splits=plan.n_splits, chunk=plan.chunk_rows, tile=plan.bucket_tile, m=m, s=s)

    def call(entry, **kw_):
        a = {**good, **kw_}
        args = (X.data_ptr(), n, d, kw.data_ptr(), 1, a["m"], a["s"], 0.25, a["rows"], a["splits"], a["chunk"],
                a["tile"], pairs.data_ptr(), partial.data_ptr(), G.data_ptr())
        row0 = (a.get("row0", 0),) if entry == "repro_sjlt_apply" else ()
        return getattr(lib, entry)(*args, *row0, torch.cuda.current_stream().cuda_stream)

    for entry in ("repro_sjlt_gram", "repro_sjlt_apply"):
        assert call(entry) == 0
        for bad in (dict(chunk=65, rows=65), dict(s=33, chunk=64), dict(rows=100), dict(splits=plan.n_splits - 1),
                    dict(splits=plan.n_splits + 1), dict(tile=0), dict(m=3000, tile=3000),
                    dict(m=2800, tile=1400), dict(m=200_000, tile=200)):
            assert call(entry, **bad) == 1, bad
    assert call("repro_sjlt_apply", row0=5) == 0
    for bad in (dict(row0=-1), dict(row0=2**32 - n + 1)):
        assert call("repro_sjlt_apply", **bad) == 1, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_q_chunking_is_bitwise_invisible(cuda, family, monkeypatch):
    _, multi, _, launches, name = FAMILIES[family]
    X = _x(2000, 9, 1, cuda)
    keys = prng.worker_keys(prng.prng_key(2), 5)
    whole = multi(keys, X, 50)
    s = SJLT_S if family == "sjlt" else 0
    shared = tcuda.shared_scratch_bytes(family, 2000, 50, 9)  # a dense Gram's split X
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", shared + 2 * tcuda.worker_scratch_bytes(family, 2000, 50, 9, s))
    assert tcuda.worker_chunk(2000, 50, 9, 5, family=family, s=s) == 2
    before = launches[name]
    assert torch.equal(multi(keys, X, 50), whole)
    assert launches[name] == before + 3  # one per chunk of workers: 2 + 2 + 1


# (n, d', m) at the edges of the dense Grams' plan (cuda.plan_dense_gram,
# clusters of GRAM_MAX_CLUSTER = 2 m-tiles of 64 rows): m below one cluster, at
# one (128) and one row either side, an odd number of m-tiles (a padding block in
# the last cluster), the ragged last cluster of FIG3A's m = 2,500 (4 live rows);
# d' = 1, 251, 256 (one column tile) and 257 (two); n not a whole number of
# 32-row steps.
GRAM_EDGES = [(3001, 251, 40), (3001, 251, 127), (3001, 256, 128), (3001, 257, 129),
              (4097, 256, 513), (2999, 1, 2500), (1001, 251, 2500), (777, 257, 64)]


@pytest.mark.parametrize("n,d,m", GRAM_EDGES)
@pytest.mark.parametrize("family", tcuda.DENSE_GRAMS)
def test_dense_gram_at_the_plan_edges(cuda, family, n, d, m):
    """The tensor-core Gram of each dense family (Gaussian, Rademacher, SRHT)
    against its float64 plain version (1e-5 per entry), its q-key slices bitwise
    single-key calls, a rerun bitwise, and no call that waits for the card."""
    single, multi, plain, *_ = FAMILIES[family]
    X = _x(n, d, n + m, cuda)
    keys = prng.worker_keys(prng.prng_key(n + d + m), 3)
    G, again = _runs_without_sync(lambda: multi(keys, X, m))
    assert G.shape == (3, d, d)
    assert _gram_err(G, plain(keys, X, m)) <= REL_TOL
    assert torch.equal(G, again)
    for w in range(3):
        assert torch.equal(G[w], single(keys[w], X, m))


@pytest.mark.parametrize("family", tcuda.DENSE_GRAMS)
def test_dense_gram_chunk_edges_are_single_key_calls(cuda, family, monkeypatch):
    """q past worker_chunk: the slices on either side of each chunk edge are
    bitwise single-key calls, and each chunk is one call into the C entry."""
    single, multi, _, launches, name = FAMILIES[family]
    n, d, m = 3001, 251, 513
    plan = tcuda.plan_dense_gram(n, m, d)
    shared = tcuda.shared_scratch_bytes(family, n, m, d)
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", shared + 3 * 4 * plan.n_splits * m * d)
    assert tcuda.worker_chunk(n, m, d, 7, family=family) == 3
    X = _x(n, d, 5, cuda)
    keys = prng.worker_keys(prng.prng_key(6), 7)
    before = launches[name]
    G = multi(keys, X, m)
    assert launches[name] == before + 3  # 3 + 3 + 1
    for w in (0, 2, 3, 5, 6):
        assert torch.equal(G[w], single(keys[w], X, m))


@pytest.mark.parametrize("block_cols", tcuda.GRAM_BLOCK_COLS)
@pytest.mark.parametrize("family", tcuda.DENSE_GRAMS)
def test_dense_gram_clusters_fit_the_card(cuda, family, block_cols):
    assert tcuda.gram_clusters(block_cols, tcuda.GRAM_MAX_CLUSTER, family) > 0


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
                                   (50, 5, 200), (25_000, 251, 2500), (3000, 2000, 300), (2000, 2049, 130),
                                   (1000, 50, 200), (500, 50, 200), (1000, 2048, 4224)])
def test_apply_kernel_matches_plain_and_single_launches(cuda, family, n, d, m):
    """Ragged n, d′ = 1, 251 and 300 (five 64-column tiles in one cluster), m = 1
    and m > n; the dense plan's cases: d′ = 2,000 (a cluster of 8), 2,049 (two
    clusters of 5, one tile dead), FIG4A's two shapes (many one-step splits) and
    one split (no partials); per column max |ΔSX_ij| / rms_i(SX_ij) ≤ 1e-5;
    q-key slices bitwise single calls."""
    single, multi, plain, *_ = APPLIES[family]
    X = _x(n, d, n + 3 * d, cuda)
    keys = prng.worker_keys(prng.prng_key(n + m), 3)
    SX = multi(keys, X, m)
    assert SX.shape == (3, m, d)
    assert _sx_err(SX, plain(keys, X, m)) <= REL_TOL
    for w in range(3):
        assert torch.equal(SX[w], single(keys[w], X, m))
    assert torch.equal(multi(keys, X, m), SX)


@pytest.mark.parametrize("family", ["gaussian", "rademacher"])
@pytest.mark.parametrize("d", [5, 251, 256])
def test_dense_apply_takes_a_view_at_any_offset(cuda, family, d):
    """The kernel copies X in 16-byte chunks from a 16-byte aligned base: a view
    that starts one row in (4·d bytes) gives the same S·X as its aligned copy."""
    single, *_ = APPLIES[family]
    X = _x(3001, d, d, cuda)[1:]
    key = prng.prng_key(d)
    assert torch.equal(single(key, X, 70), single(key, X.clone(), 70))


@pytest.mark.parametrize("family", ["gaussian", "rademacher", "sjlt"])
def test_apply_is_bitwise_the_sketch_the_gram_kernel_contracts(cuda, family):
    """The fused Gram kernel's G against the Gram of the S·A kernel's S·X. The
    SJLT's two share the sketch pass, the plan and the split reduction, so its G
    is bitwise the Gram pass's fmaf chain (over m, ascending, from 0) on S·X; fmaf
    is taken as one rounding of the exact float64 product-sum (a double rounding
    could differ in about 1 of 2**29 steps). The dense S·A runs on the tensor
    cores with its own plan, so there G agrees with (S·X)ᵀ(S·X) within the Gram
    tolerance, 1e-5 per entry."""
    single_gram = FAMILIES[family][0]
    single_apply = APPLIES[family][0]
    X = _x(4000, 19, 7, cuda)
    key = prng.prng_key(8)
    SX = single_apply(key, X, 96).double()
    if family != "sjlt":
        assert _gram_err(single_gram(key, X, 96), SX.T @ SX) <= REL_TOL
        return
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
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 2 * tcuda.worker_scratch_bytes(family, 2000, 50, 9, s, apply=True))
    assert tcuda.worker_chunk(2000, 50, 9, 5, family=family, s=s, apply=True) == 2
    before = launches[name]
    assert torch.equal(multi(keys, X, 50), whole)
    assert launches[name] == before + 3  # one per chunk of workers: 2 + 2 + 1


def _runs_without_sync(call):
    """call() once to build and load its library, then again under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for the card
    raises. Returns both results."""
    want = call()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return got, want


@pytest.mark.parametrize("family", ["gaussian", "rademacher"])
@pytest.mark.parametrize("q", [1, 3])
def test_dense_apply_makes_no_synchronising_call(cuda, family, q):
    """A dense S·A (keys on the host, as the paths pass them; one key or several)
    copies its key words through pinned memory and launches without waiting for
    the card."""
    single, multi, *_ = APPLIES[family]
    X = _x(1000, 50, 17, cuda)
    if q == 1:
        got, want = _runs_without_sync(lambda: single(prng.prng_key(17), X, 200))
    else:
        got, want = _runs_without_sync(lambda: multi(prng.worker_keys(prng.prng_key(17), q), X, 200))
    assert torch.equal(got, want)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gram_makes_no_synchronising_call(cuda, family):
    """The Gram wrappers share the S·A's key copy (``cuda._u32_words``; the SRHT's
    row ids too): a single-key and a multi-key Gram wait for nothing."""
    single, multi, *_ = FAMILIES[family]
    X = _x(1000, 20, 18, cuda)
    keys = prng.worker_keys(prng.prng_key(18), 3)
    got, want = _runs_without_sync(lambda: (single(keys[0], X, 64), multi(keys, X, 64)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_sjlt_apply_and_adjoint_make_no_synchronising_call(cuda):
    """The SJLT S·A, both Gaussian adjoints and the S·A that keeps its S wait for
    nothing."""
    X = _x(1000, 20, 19, cuda)
    Y = _x(64, 3, 20, cuda)
    keys = prng.worker_keys(prng.prng_key(19), 3)
    S = gops.gaussian_sketch_keep(keys[0], X, 64)[1]
    got, want = _runs_without_sync(lambda: (
        sops.sjlt_apply(keys[0], X, 64, SJLT_S), sops.sjlt_apply_multi(keys, X, 64, SJLT_S),
        gops.gaussian_adjoint(keys[0], Y, 1000), *gops.gaussian_sketch_keep(keys[0], X, 64),
        gops.gaussian_adjoint_kept(S, Y, 1000)))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mma_probe_fragment_layouts_and_3xtf32(cuda):
    """One warp's m16n8k8 TF32 product through the fragment layouts the dense S·A
    uses: the 3xTF32 form within 1e-6 of the float64 product (relative to its
    largest entry), one TF32 product off by far more."""
    rs = np.random.default_rng(16)
    A = torch.from_numpy(rs.standard_normal((16, 8)).astype(np.float32))
    B = torch.from_numpy(rs.standard_normal((8, 8)).astype(np.float32))
    d1, d3 = tcuda.mma_probe(A.to(cuda), B.to(cuda))
    want = A.double() @ B.double()
    scale = float(want.abs().max())
    assert float((d3.cpu().double() - want).abs().max()) <= 1e-6 * scale
    err1 = float((d1.cpu().double() - want).abs().max())
    assert 1e-5 * scale < err1 <= 4e-3 * scale


@pytest.mark.parametrize("block_cols", tcuda.APPLY_BLOCK_COLS)
def test_dense_apply_clusters_fit_the_card(cuda, block_cols):
    """A cluster of the largest size the plan takes can be resident at every width."""
    assert tcuda.apply_clusters(block_cols, tcuda.APPLY_MAX_CLUSTER) > 0


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
    """One count a call under each wrapper's name; the SJLT's at most 8 columns
    under the long-column entry's names (row 12b), past them under its own."""
    X = _x(500, 12, 3, cuda)
    keys = prng.worker_keys(prng.prng_key(4), 2)
    for single, multi, _, launches, name in APPLIES.values():
        single_name = name.removesuffix("_multi")
        before = launches[single_name], launches[name]
        single(keys[0], X, 16)
        multi(keys, X, 16)
        assert (launches[single_name], launches[name]) == (before[0] + 1, before[1] + 1)
    before = dict(sops.LAUNCHES)
    sops.sjlt_apply(keys[0], X[:, :4].contiguous(), 16, SJLT_S)
    sops.sjlt_apply_multi(keys, X[:, :4].contiguous(), 16, SJLT_S)
    grew = {k: v - before.get(k, 0) for k, v in sops.LAUNCHES.items() if v != before.get(k, 0)}
    assert grew == {"sjlt_apply_long": 1, "sjlt_apply_long_multi": 1}


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


# The least-norm paths' adjoint shapes (chip_smoke.py ADJOINT_SHAPES) and an n that
# is not a multiple of 4 (the kept S's rows padded to 16 bytes).
KEPT_SHAPES = [(4000, 11_556, 1), (4000, 8000, 1), (200, 1000, 1), (200, 500, 1), (129, 1001, 3),
               (200, 1001, 1), (63, 129, 1), (1, 1, 1), (300, 1001, 33)]


@pytest.mark.parametrize("m,n,k", KEPT_SHAPES)
def test_kept_adjoint_matches_plain_and_redraw(cuda, m, n, k):
    """The kept-S adjoint over the S its forward kept: per column within 1e-5 of
    the rms against the float64 product of the same S, bitwise the redraw kernel
    on the same key (same splits, chains and split order), bitwise run to run,
    one launch a call."""
    key = prng.prng_key(m * n + k)
    SX, S = gops.gaussian_sketch_keep(key, _x(n, 2, n, cuda), m)
    assert S.shape == (m, tcuda.kept_sketch_ld(n))
    Y = _x(m, k, m + k, cuda)
    before = gops.LAUNCHES["gaussian_adjoint_kept"]
    out = gops.gaussian_adjoint_kept(S, Y, n)
    assert gops.LAUNCHES["gaussian_adjoint_kept"] == before + 1
    assert out.shape == (n, k)
    assert _sx_err(out, gref.adjoint_kept(S, Y, n)) <= REL_TOL
    assert _sx_err(out, gref.adjoint(key, Y, n)) <= REL_TOL
    assert torch.equal(out, gops.gaussian_adjoint(key, Y, n))
    assert torch.equal(gops.gaussian_adjoint_kept(S, Y, n), out)


@pytest.mark.parametrize("m,n,d", [(4000, 11_556, 64), (200, 1000, 50), (200, 1001, 5), (130, 1000, 2049),
                                   (64, 33, 1)])
def test_sketch_apply_keeping_s_is_bitwise_and_keeps_the_drawn_s(cuda, m, n, d):
    """With s_out, S·X is bitwise S·X without it (one split or many; at d = 2,049
    two cluster groups draw each entry, and only the first stores it), and the
    kept S is the counter S within the draw's tolerance (2e-6 a normal, scaled
    by 1/√m)."""
    key = prng.prng_key(n + d)
    X = _x(n, d, d, cuda)
    SX, S = gops.gaussian_sketch_keep(key, X, m)
    assert torch.equal(SX, gops.gaussian_sketch(key, X, m))
    want = gref.sketch_matrix(key, m, n, device=cuda)
    assert float((S[:, :n] - want).abs().max()) <= 2e-6 * common.inv_sqrt(m)


def test_sketch_apply_refuses_to_keep_what_it_cannot(cuda):
    """s_out only for the Gaussian with one key and an (m, ld) buffer, ld >= n a
    multiple of 4: the wrapper raises, and the C entry refuses (1) before
    launching anything."""
    key = prng.prng_key(0)
    X = _x(100, 4, 0, cuda)
    good = torch.empty((16, 100), device=cuda)
    kw = dict(rounds=20, launches=gops.LAUNCHES, name="x")
    with pytest.raises(ValueError, match="one key"):
        tcuda.sketch_apply("gaussian", prng.worker_keys(key, 2), X, 16, s_out=good, **kw)
    with pytest.raises(ValueError, match="one key"):
        tcuda.sketch_apply("rademacher", key.reshape(1, 2), X, 16, s_out=good, **kw)
    for bad in (torch.empty((16, 102), device=cuda), torch.empty((16, 96), device=cuda),
                torch.empty((15, 100), device=cuda), torch.empty((16, 101), device=cuda)[:, :100]):
        with pytest.raises(ValueError):
            tcuda.sketch_apply("gaussian", key.reshape(1, 2), X, 16, s_out=bad, **kw)
    lib = tcuda._library("sketch_apply")
    plan = tcuda.plan_apply(100, 16, 4)
    kwords = tcuda._u32_words(prng.worker_keys(key, 2), cuda)
    out = torch.empty((2, 16, 4), device=cuda)
    partial = torch.empty(2 * plan.n_splits * 16 * 4, device=cuda)
    S = torch.empty(16 * 104 + 4, device=cuda)

    def call(family=0, q=1, s_ptr=S.data_ptr(), ld=100, row0=0):
        return lib.repro_sketch_apply(family, X.data_ptr(), 100, 4, kwords.data_ptr(), q, 16, 0.25, 20,
                                      plan.rows_per_split, plan.n_splits, plan.block_cols, plan.cluster, plan.groups,
                                      partial.data_ptr(), out.data_ptr(), s_ptr, ld, row0,
                                      torch.cuda.current_stream().cuda_stream)

    assert call() == 0
    assert call(s_ptr=None, row0=7) == 0 and call(family=1, s_ptr=None, row0=64) == 0
    for bad in (dict(q=2), dict(family=1), dict(ld=102), dict(ld=96), dict(s_ptr=S.data_ptr() + 4),
                dict(row0=32), dict(s_ptr=None, row0=-1), dict(family=1, s_ptr=None, row0=7),
                dict(s_ptr=None, row0=2**32 - 99)):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()


def test_kept_adjoint_refuses_what_it_cannot_take(cuda):
    Y = _x(16, 1, 0, cuda)
    S = torch.empty((16, 100), device=cuda)
    with pytest.raises(ValueError, match="kept S"):
        gops.gaussian_adjoint_kept(torch.empty((16, 98), device=cuda), Y, 100)
    with pytest.raises(ValueError, match="kept S"):
        gops.gaussian_adjoint_kept(torch.empty((15, 100), device=cuda), Y, 100)
    with pytest.raises(ValueError, match="contiguous"):
        gops.gaussian_adjoint_kept(S, _x(2, 16, 0, cuda).T, 100)
    lib = tcuda._library("adjoint")
    out = torch.empty(100, device=cuda)

    def call(ld=100, ptr=S.data_ptr(), splits=1, rows=16):
        return lib.repro_adjoint_kept(ptr, ld, Y.data_ptr(), 16, 1, 100, rows, splits, out.data_ptr(), 0,
                                      torch.cuda.current_stream().cuda_stream)

    assert call() == 0
    for bad in (dict(ld=98), dict(ld=102), dict(ptr=S.data_ptr() + 4), dict(splits=65, rows=1),
                dict(splits=2, rows=4), dict(splits=2, rows=16)):
        assert call(**bad) == 1, bad
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["gaussian", "hybrid_gaussian"])
def test_least_norm_keeps_s_and_reads_it_back(cuda, kind, monkeypatch):
    """A Gaussian least-norm worker (alone or inside the hybrid) makes one forward
    that keeps S and one kept-S adjoint, and no redraw; with a scratch one byte
    short of S it redraws instead, and x̄ agrees (bitwise: the same splits,
    chains and S)."""
    rs = np.random.default_rng(21)
    A = torch.from_numpy(rs.standard_normal((30, 1500)).astype(np.float32))
    b = torch.from_numpy(rs.standard_normal(30).astype(np.float32))
    if kind == "gaussian":
        spec, n = sketches.SketchSpec("gaussian", 120, use_kernel=True), 1500
    else:
        spec, n = sketches.SketchSpec("hybrid", 120, m_prime=400, inner="gaussian", use_kernel=True), 400
    key = prng.prng_key(22)
    gops.LAUNCHES.clear()
    kept = distributed.distributed_sketch_least_norm(spec, key, A, b, q=3)
    assert dict(gops.LAUNCHES) == {"gaussian_sketch": 3, "gaussian_adjoint_kept": 3}
    monkeypatch.setattr(tcuda, "SCRATCH_BYTES", 4 * 120 * tcuda.kept_sketch_ld(n) - 1)
    gops.LAUNCHES.clear()
    redrawn = distributed.distributed_sketch_least_norm(spec, key, A, b, q=3)
    assert dict(gops.LAUNCHES) == {"gaussian_sketch": 3, "gaussian_adjoint": 3}
    assert torch.equal(kept, redrawn)


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


def _srht_case(log_n, k, m, seed, device):
    """(kd0, kd1, rows, A, n_pad) of an SRHT at n_pad = 2**log_n with ragged n
    (n_pad − n_pad // 3 rows), m sampled rows (repeats where m nears n_pad)."""
    n_pad = 1 << log_n
    n = n_pad - n_pad // 3
    op = operators.make_operator(sketches.SketchSpec("srht", m), prng.prng_key(seed), n)
    assert op.n_pad == n_pad
    return op.kd0, op.kd1, op.rows, _x(n, k, seed, device), n_pad


@pytest.mark.parametrize("log_n", list(range(0, 21)))
@pytest.mark.parametrize("k", [1, 33, 251])
def test_srht_forward_is_bitwise_the_plain_version(cuda, log_n, k):
    """The fused SRHT forward at n_pad = 1 to 2**20 (one, two and the first
    three-pass plans' edges), ragged n, m = 2,500 sampled rows (every row many
    times at small n_pad; groups of the last pass with no sampled row at
    2**19), one launch a call, bitwise its plain version and its rerun."""
    if k == 251 and log_n > 19:
        k = 33
    kd0, kd1, rows, A, n_pad = _srht_case(log_n, k, 2500, log_n, cuda)
    before = dict(fops.LAUNCHES)
    got = fops.srht_forward(kd0, kd1, rows, A, n_pad)
    assert fops.LAUNCHES["srht_forward"] == before.get("srht_forward", 0) + 1
    assert fops.LAUNCHES["fwht"] == before.get("fwht", 0)
    assert got.shape == (2500, k)
    assert torch.equal(got, fref.srht_forward(kd0, kd1, rows, A, n_pad))
    assert torch.equal(fops.srht_forward(kd0, kd1, rows, A, n_pad), got)


@pytest.mark.parametrize("log_n,m", [(2, 5000), (10, 20000), (11, 9000), (15, 1)])
def test_srht_forward_with_more_samples_than_a_thread_keeps_bits_of(cuda, log_n, m):
    """More sampled ids than a last-pass block's threads keep hit bits of (32
    chunks of the block's 256 or, for the 10-stage tile, 512 threads: the rest
    read again when written), many hits a group, and a sample of one row (every
    other group skips)."""
    kd0, kd1, rows, A, n_pad = _srht_case(log_n, 5, m, 40 + log_n, cuda)
    assert torch.equal(fops.srht_forward(kd0, kd1, rows, A, n_pad), fref.srht_forward(kd0, kd1, rows, A, n_pad))


@pytest.mark.parametrize("kind,n,m_prime", [("srht", 3000, 0), ("hybrid", 3000, 800), ("srht", 1000, 0)])
def test_srht_apply_on_the_card_goes_through_the_fused_forward(cuda, kind, n, m_prime):
    """``SRHTOp.apply`` (alone or as the hybrid's inner sketch) with ``use_kernel``
    is one srht_forward call and no FWHT, bitwise the ``use_kernel=False`` apply."""
    spec = sketches.SketchSpec(kind, 80, m_prime=m_prime, inner="srht")
    op = operators.make_operator(dataclasses.replace(spec, use_kernel=True), prng.prng_key(23), n)
    plain = operators.make_operator(spec, prng.prng_key(23), n)
    X = _x(n, 13, 24, cuda)
    fops.LAUNCHES.clear()
    got = op.apply(X)
    assert dict(fops.LAUNCHES) == {"srht_forward": 1}
    assert torch.equal(got, plain.apply(X))
    assert torch.equal(op.apply(X[:, 3]), got[:, 3])


def test_srht_forward_makes_no_synchronising_call(cuda):
    kd0, kd1, rows, A, n_pad = _srht_case(12, 7, 300, 25, cuda)
    got, want = _runs_without_sync(lambda: fops.srht_forward(kd0, kd1, rows, A, n_pad))
    assert torch.equal(got, want)


def test_srht_forward_rejects_what_the_kernel_does_not_take(cuda):
    kd0, kd1, rows, A, n_pad = _srht_case(10, 4, 50, 26, cuda)
    with pytest.raises(ValueError, match="float32"):
        fops.srht_forward(kd0, kd1, rows, A.double(), n_pad)
    with pytest.raises(ValueError, match="contiguous"):
        fops.srht_forward(kd0, kd1, rows, _x(4, A.shape[0], 0, cuda).T, n_pad)
    with pytest.raises(ValueError, match=r"\[0, n_pad"):
        fops.srht_forward(kd0, kd1, torch.tensor([0, n_pad]), A, n_pad)
    with pytest.raises(ValueError, match=r"\[0, n_pad"):
        fops.srht_forward(kd0, kd1, torch.tensor([-1, 3]), A, n_pad)
    with pytest.raises(ValueError, match="on the CPU"):
        fops.srht_forward(kd0, kd1, rows.to(cuda), A, n_pad)
    with pytest.raises(ValueError, match="int32 or int64"):
        fops.srht_forward(kd0, kd1, rows.float(), A, n_pad)
    with pytest.raises(ValueError, match="power-of-two"):
        fops.srht_forward(kd0, kd1, rows, A, n_pad + 1)
    with pytest.raises(ValueError, match="unsupported shape"):
        fops.srht_forward(kd0, kd1, rows, A, n_pad // 2)


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


# ------------------------------------------------------------ row offsets (row0)

ROW0_FNS = {
    "gaussian": (lambda k, X, m, r: gops.gaussian_sketch(k, X, m, row0=r),
                 lambda k, X, m, r: gref.sketch(k, X, m, row0=r)),
    "rademacher": (lambda k, X, m, r: rops.rademacher_sketch(k, X, m, row0=r),
                   lambda k, X, m, r: rref.sketch(k, X, m, row0=r)),
    "sjlt": (lambda k, X, m, r: sops.sjlt_apply(k, X, m, SJLT_S, row0=r),
             lambda k, X, m, r: sref.sketch(k, X, m, SJLT_S, row0=r)),
}


@pytest.mark.parametrize("family", list(ROW0_FNS))
def test_row0_zero_is_the_whole_matrix_call_bitwise(cuda, family):
    """row0 = 0 passed explicitly is the call without it, bit for bit, and the
    slice of a multi-key call."""
    kernel, _ = ROW0_FNS[family]
    X = _x(3001, 251, 5, cuda)
    keys = prng.worker_keys(prng.prng_key(3), 2)
    plain = {"gaussian": gops.gaussian_sketch, "rademacher": rops.rademacher_sketch,
             "sjlt": lambda k, X, m: sops.sjlt_apply(k, X, m, SJLT_S)}[family]
    multi = {"gaussian": gops.gaussian_sketch_multi, "rademacher": rops.rademacher_sketch_multi,
             "sjlt": lambda k, X, m: sops.sjlt_apply_multi(k, X, m, SJLT_S)}[family]
    got = kernel(keys[1], X, 200, 0)
    assert torch.equal(got, plain(keys[1], X, 200))
    assert torch.equal(got, multi(keys, X, 200)[1])


@pytest.mark.parametrize("row0", [32, 4096, 499_968])
@pytest.mark.parametrize("family", list(ROW0_FNS))
def test_row0_tile_matches_plain_and_tiles_sum_to_whole(cuda, family, row0):
    """A tile at row0 against its plain version at the same offset (the S·A
    rows' measure, 1e-5), a rerun bitwise, and the tiles of a matrix summed in
    order against the whole-matrix kernel call (the same measure)."""
    kernel, plain = ROW0_FNS[family]
    m = 320
    X = _x(4096, 67, row0 % 97, cuda)
    key = prng.prng_key(row0 % 13)
    got = kernel(key, X, m, row0)
    assert torch.equal(got, kernel(key, X, m, row0))
    assert _sx_err(got.cpu(), plain(key, X.cpu(), m, row0)) <= REL_TOL
    whole = kernel(key, X, m, 0)
    parts = None
    for j in range(0, 4096, 1024):
        part = kernel(key, X[j : j + 1024].contiguous(), m, j)
        parts = part if parts is None else parts + part
    assert _sx_err(parts.cpu(), whole.cpu()) <= REL_TOL


@pytest.mark.parametrize("block_rows", [4096, 5000])
@pytest.mark.parametrize("family", ["gaussian", "sjlt"])
def test_host_stream_reruns_bitwise_and_matches_gram_blocked(cuda, family, block_rows):
    """``gram_blocked_host`` over a pinned numpy [A | b] on the card: a rerun
    is bitwise, the kernel tiles were launched once each, and G against
    ``gram_blocked``'s (the Gram rows' measure, 1e-5)."""
    n, d, m = 20_011, 40, 256
    A = _x(n, d, 1, "cpu").numpy()
    b = _x(n, 1, 2, "cpu")[:, 0].numpy()
    spec = sketches.SketchSpec(family, m, s=SJLT_S, use_kernel=True)
    key = prng.prng_key(9)
    mod, name = (gops, "gaussian_sketch") if family == "gaussian" else (sops, "sjlt_apply")
    before = mod.LAUNCHES[name]
    G, c = operators.gram_blocked_host(spec, key, A, b, block_rows=block_rows)
    assert mod.LAUNCHES[name] - before == -(-n // block_rows)
    G2, c2 = operators.gram_blocked_host(spec, key, A, b, block_rows=block_rows)
    assert torch.equal(G, G2) and torch.equal(c, c2)
    Gw, cw = operators.gram_blocked(spec, key, torch.from_numpy(A).to(cuda), torch.from_numpy(b).to(cuda))
    assert _gram_err(G.cpu(), Gw.cpu()) <= REL_TOL


@pytest.mark.parametrize("family", ["gaussian", "sjlt"])
def test_runtime_thread_backend_is_bitwise_inline_on_the_card(cuda, family):
    """The serverless runtime on the card: 8 threads launching the single-key Gram
    give the inline run's log byte for byte and its x̄ bitwise, and each arrival
    made exactly one kernel call (the counters are exact under threads)."""
    from repro_torch import runtime as rt

    A, b = _x(4096, 24, 1, cuda), _x(4096, 1, 2, cuda)[:, 0]
    spec = sketches.SketchSpec(family, 128, s=SJLT_S, use_kernel=True)
    launches, name = FAMILIES[family][3], f"{family}_gram"
    lat = rt.HeavyTailLatency(seed=3, scale_s=0.5, alpha=1.5)
    runs = {}
    for backend in ("inline", "thread"):
        before = launches[name]
        runs[backend] = rt.serverless_sketch_solve(spec, prng.prng_key(4), A, b, q=32, latency=lat,
                                                   config=rt.RuntimeConfig(max_threads=8), backend=backend)
        assert launches[name] - before == runs[backend].count
    assert runs["thread"].events.lines() == runs["inline"].events.lines()
    np.testing.assert_array_equal(runs["thread"].xbar, runs["inline"].xbar)
    assert runs["inline"].events.counts().get("retry", 0) > 0


def test_process_backend_children_reach_the_card(cuda):
    """Spawned workers make their own device copy and launch the kernels there:
    the log and x̄ are the inline run's."""
    from repro_torch import runtime as rt

    A, b = _x(2048, 12, 3, cuda), _x(2048, 1, 4, cuda)[:, 0]
    spec = sketches.SketchSpec("sjlt", 96, s=SJLT_S, use_kernel=True)
    lat = rt.DropLatency(seed=5, inner=rt.LognormalLatency(seed=5, mean_s=0.4, sigma=0.6), drop_prob=0.2)
    cfg = rt.RuntimeConfig(deadline_s=0.5, max_threads=2)
    inline = rt.serverless_sketch_solve(spec, prng.prng_key(6), A, b, q=8, latency=lat, config=cfg, backend="inline")
    proc = rt.serverless_sketch_solve(spec, prng.prng_key(6), A, b, q=8, latency=lat, config=cfg, backend="process")
    assert proc.events.lines() == inline.events.lines()
    np.testing.assert_array_equal(proc.xbar, inline.xbar)


# ------------------------------------------- row 12b: the SJLT S·A of few, long columns

# (n, m, d′, s): gradient compression's CountSketch from a small vector to
# gradcomp_bench's full one (D = 2^20 + 2^16) at ratios 0.01, 0.1 and 0.25, m
# past plan_sjlt's 31,744 rows, d′ = 8 and s = 4.
LONG_CASES = [(4096, 64, 1, 1), (2**20 + 2**16, 11_142, 1, 1), (2**20 + 2**16, 111_412, 1, 1),
              (2**20 + 2**16, 278_528, 1, 1), (100_000, 40_000, 8, 1), (65_536, 3000, 1, 4), (30_001, 997, 8, 4)]


def _bucket_mass(key, X, m, s, row0=0):
    """Σ|terms| of each (bucket, column) of S·X, in float64 (the measure's denominator)."""
    k0, k1 = common.key_words(key)
    n, d = X.shape
    buckets, _ = common.sjlt_counter_params(k0, k1, row0 + torch.arange(n, device=X.device), s, m)
    terms = X.double().abs().repeat_interleave(s, dim=0) * common.inv_sqrt(s)
    return torch.zeros((m, d), dtype=torch.float64, device=X.device).index_add_(0, buckets.reshape(-1), terms)


def _bucket_err(got, want, mass) -> float:
    return float(((got.double() - want.double()).abs() / mass.clamp_min(1e-300)).max())


@pytest.mark.parametrize("n,m,d,s", LONG_CASES)
def test_long_column_apply_matches_plain_per_bucket(cuda, n, m, d, s):
    """Per bucket, max |Δ| / Σ|terms| ≤ 1e-6 against the plain version; bitwise
    its fixed-point model (``_sjlt_fixed_point.sketch_fixed_point``) and bitwise run to
    run; one call into the long-column entry; q-key slices bitwise single keys."""
    X = _x(n, d, n + m, cuda) * torch.exp2(torch.from_numpy(
        np.random.default_rng(m).integers(-10, 11, (n, 1))).to(cuda, torch.float32))
    keys = prng.worker_keys(prng.prng_key(m + s), 2)
    before = dict(sops.LAUNCHES)
    got = sops.sjlt_apply(keys[0], X, m, s)
    assert sops.LAUNCHES["sjlt_apply_long"] == before.get("sjlt_apply_long", 0) + 1
    assert sops.LAUNCHES["sjlt_apply"] == before.get("sjlt_apply", 0)
    want = sref.sketch(keys[0], X, m, s)
    assert _bucket_err(got, want, _bucket_mass(keys[0], X, m, s)) <= 1e-6
    assert torch.equal(got, fixed.sketch_fixed_point(keys[0], X, m, s))
    assert torch.equal(sops.sjlt_apply(keys[0], X, m, s), got)
    multi = sops.sjlt_apply_multi(keys, X, m, s)
    assert torch.equal(multi[0], got) and torch.equal(multi[1], sops.sjlt_apply(keys[1], X, m, s))


@pytest.mark.parametrize("row0", [17, 4096, 2**32 - 8192])
def test_long_column_row0_keeps_its_meaning(cuda, row0):
    """A tile at row0 against the plain version at that offset; row0 = 0 passed
    explicitly is the call without it; the tiles of a column summed in order
    against the whole call (per bucket, 1e-6 of Σ|terms|)."""
    n, m, d, s = 8192, 512, 2, 1
    X = _x(n, d, row0 % 89, cuda)
    key = prng.prng_key(row0 % 31)
    got = sops.sjlt_apply(key, X, m, s, row0=row0)
    assert _bucket_err(got, sref.sketch(key, X, m, s, row0=row0), _bucket_mass(key, X, m, s, row0)) <= 1e-6
    whole = sops.sjlt_apply(key, X, m, s)
    assert torch.equal(sops.sjlt_apply(key, X, m, s, row0=0), whole)
    parts = sum(sops.sjlt_apply(key, X[j : j + 2048].contiguous(), m, s, row0=j) for j in range(0, n, 2048))
    assert _bucket_err(parts, whole, _bucket_mass(key, X, m, s)) <= 1e-6


def test_long_column_apply_keeps_infinities_and_nans(cuda):
    X = _x(5000, 2, 3, cuda)
    X[5, 0], X[9, 1], X[11, 1] = float("inf"), float("nan"), -float("inf")
    key = prng.prng_key(4)
    got, want = sops.sjlt_apply(key, X, 40, 1), sref.sketch(key, X, 40, 1)
    assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
    inf = got.isinf()
    assert torch.equal(got[inf], want[inf])
    fin = want.isfinite()
    assert torch.equal(got[fin], fixed.sketch_fixed_point(key, X, 40, 1)[fin])


@pytest.mark.parametrize("n,d,m", [(3001, 251, 2500), (1000, 50, 200), (2000, 40, 3100), (300, 9, 12_000)])
def test_old_entry_is_the_path_for_the_shapes_it_keeps(cuda, n, d, m):
    """Past 8 columns and within the m-tiles the S·A is the bin and scatter
    passes' entry, bit for bit, and counts as it did."""
    X = _x(n, d, 5, cuda)
    keys = prng.worker_keys(prng.prng_key(n), 2)
    before = dict(sops.LAUNCHES)
    got = sops.sjlt_apply_multi(keys, X, m, SJLT_S)
    assert sops.LAUNCHES["sjlt_apply_multi"] == before.get("sjlt_apply_multi", 0) + 1
    assert sops.LAUNCHES.get("sjlt_apply_long_multi", 0) == before.get("sjlt_apply_long_multi", 0)
    assert torch.equal(got, tcuda.sjlt_apply(keys, X, m, SJLT_S, launches=sops.LAUNCHES, name="x"))


@pytest.mark.parametrize("n,d,m", [(1001, 7, 40), (33, 1, 1), (777, 5, 1536)])
def test_old_entry_still_takes_the_shapes_that_moved(cuda, n, d, m):
    """The bin and scatter passes, called directly, still compute S·X at the
    shapes that now go to the long-column entry (the S·A rows' measure)."""
    X = _x(n, d, 6, cuda)
    keys = prng.worker_keys(prng.prng_key(m), 2)
    got = tcuda.sjlt_apply(keys, X, m, SJLT_S, launches=sops.LAUNCHES, name="x")
    assert _sx_err(got, sref.sketch_multi(keys, X, m, SJLT_S)) <= REL_TOL


def test_long_column_apply_makes_no_synchronising_call(cuda):
    X = _x(2**16, 1, 7, cuda)
    keys = prng.worker_keys(prng.prng_key(7), 2)
    got, want = _runs_without_sync(lambda: (sops.sjlt_apply(keys[0], X, 6554, 1),
                                            sops.sjlt_apply_multi(keys, X, 6554, 1)))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_long_column_entry_refuses_what_it_cannot_take(cuda):
    lib = tcuda._library("sjlt_gram")
    n, d, m, s = 1000, 1, 64, 1
    X = _x(n, d, 0, cuda)
    kw = tcuda._host_key_words(prng.worker_keys(prng.prng_key(0), 1))
    plan = tcuda.plan_sjlt_long(n, m, d, s)
    size = lib.repro_sjlt_long_scratch_bytes(n, d, m, s, plan.bucket_tile, plan.group_parts, plan.sub,
                                             plan.chunk_pairs, plan.cols)
    scratch = torch.empty(size // 8 + 2, dtype=torch.int64, device=cuda)
    pairs = torch.empty(n * s, dtype=torch.int32, device=cuda)
    out = torch.empty((m, d), dtype=torch.float32, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream

    def call(n=n, m=m, s=s, row0=0, q=1, offset=0, keys=kw, bucket_tile=plan.bucket_tile,
             group_parts=plan.group_parts, sub=plan.sub, chunk_pairs=plan.chunk_pairs, cols=plan.cols, size=size):
        return lib.repro_sjlt_apply_long(X.data_ptr(), n, d, keys, q, m, s, 1.0, row0, bucket_tile, group_parts,
                                         sub, chunk_pairs, cols, pairs.data_ptr(), scratch.data_ptr() + offset, size,
                                         out.data_ptr(), stream)

    assert call() == 0
    for bad in (dict(n=0), dict(m=0), dict(s=0), dict(q=0), dict(row0=-1), dict(row0=2**32 - n + 1),
                dict(offset=8), dict(keys=None), dict(bucket_tile=m + 1), dict(group_parts=-1), dict(sub=1),
                dict(group_parts=4, sub=0), dict(chunk_pairs=1000), dict(cols=0), dict(cols=2), dict(size=size - 16)):
        assert call(**bad) == 1, bad
    assert lib.repro_sjlt_long_scratch_bytes(n, d, m, s, m + 1, 0, 0, plan.chunk_pairs, plan.cols) == -1
    with pytest.raises(ValueError, match="n·s"):
        tcuda.sjlt_apply_long(prng.worker_keys(prng.prng_key(0), 1), X, m, 2**23, launches=sops.LAUNCHES, name="x")
    with pytest.raises(ValueError, match="from the host"):
        tcuda.sjlt_apply_long(prng.worker_keys(prng.prng_key(0), 1).to(cuda), X, m, s, launches=sops.LAUNCHES,
                              name="x")
    torch.cuda.synchronize()


@pytest.mark.parametrize("n,m,d,s", [(200_003, 50_000, 3, 1), (60_000, 40_000, 11, 2)])
def test_long_column_sum_is_the_same_on_every_plan(cuda, n, m, d, s, monkeypatch):
    """Larger or smaller partitions, one level or two, other chunks and column
    groups: the output is bitwise ``sketch_fixed_point`` on every plan (every
    sum is of exact integers)."""
    X = _x(n, d, m, cuda) * torch.exp2(torch.from_numpy(
        np.random.default_rng(n).integers(-10, 11, (n, 1))).to(cuda, torch.float32))
    key = prng.prng_key(m)
    want = fixed.sketch_fixed_point(key, X, m, s)
    base = tcuda.plan_sjlt_long(n, m, d, s)
    plans = [base]
    # bucket_tile, group_parts (0: one level), sub, chunk_pairs, cols
    for tile, grp, sub, chunk, cols in ((1000, 0, 0, 4096, base.cols), (1000, 0, 0, 2048, 2), (7232, 0, 0, 1024, 1),
                                        (333, 0, 0, 8192, base.cols), (333, 13, 5, 3072, base.cols),
                                        (100, 8, 40, 1024, 2), (100, 23, 1, 1024, 1)):
        plans.append(dataclasses.replace(base, bucket_tile=tile, parts=-(-m // tile), group_parts=grp, sub=sub,
                                         chunk_pairs=chunk, chunks=-(-base.pairs // chunk), cols=cols))
    for plan in plans:
        assert plan.acc_smem <= tcuda.SJLT_LONG_ACC_SMEM
        monkeypatch.setattr(tcuda, "plan_sjlt_long", lambda *a, plan=plan: plan)
        assert torch.equal(sops.sjlt_apply(key, X, m, s), want), plan


@pytest.mark.parametrize("n,m,d,s", [(1000, 64, 1, 1), (200_003, 50_000, 3, 1), (2**28, 26_843_546, 1, 1),
                                     (2**20 + 2**16, 11_142, 8, 4), (2**32 - 1, 2**31 - 1, 1, 1)])
def test_long_scratch_mirror_is_the_entrys_layout(cuda, n, m, d, s):
    """``LongPlan.scratch_bytes`` (the host's mirror, for planning memory) is
    the C entry's own count, one level and two."""
    lib = tcuda._library("sjlt_gram")
    plan = tcuda.plan_sjlt_long(n, m, d, s)
    assert lib.repro_sjlt_long_scratch_bytes(n, d, m, s, plan.bucket_tile, plan.group_parts, plan.sub,
                                             plan.chunk_pairs, plan.cols) == plan.scratch_bytes


@pytest.mark.parametrize("n,m,d,s", [(4096, 64, 1, 1), (2**20 + 2**16, 111_412, 1, 1), (100_000, 40_000, 8, 1),
                                     (30_001, 997, 3, 4), (2**20 + 2**16, 11_142, 1, 1),
                                     (2**22 + 4096, 2_000_000, 1, 1), (2**21 + 77, 500_000, 2, 2)])
def test_long_column_partition_pass_is_its_plain_version(cuda, n, m, d, s):
    """The count, scan and scatter passes alone (``repro_sjlt_long_partition``;
    two levels at the last two shapes): the pair list, each partition's first
    entry and the entries, word for word the plain model's
    (``sjlt.ref.long_partition``), and bitwise run to run."""
    X = _x(n, d, m, cuda)
    key = prng.prng_key(n + m)
    plan = tcuda.plan_sjlt_long(n, m, d, s)
    assert (plan.group_parts > 0) == (n > 2**21)
    got = tcuda.sjlt_long_partition(key, X, m, s)
    pairs = sref.long_pairs(key, n, m, s)
    assert torch.equal(got["pairs"].cpu(), pairs)
    want = sref.long_partition(pairs, X.cpu(), s, plan)
    entries = int(want["base"][-1])
    assert torch.equal(got["base"].cpu().to(torch.int64), want["base"])
    assert torch.equal(got["ebucket"][:entries].cpu().to(torch.int64) & 0xFFFF, want["ebucket"])
    assert torch.equal(got["evals"][:entries].cpu().view(torch.int32), want["evals"].view(torch.int32))
    again = tcuda.sjlt_long_partition(key, X, m, s)
    assert all(torch.equal(got[k][:entries], again[k][:entries]) for k in ("ebucket", "evals"))


@pytest.mark.parametrize("ratio", [0.01, 0.1])
def test_decompress_reads_the_kept_pairs_bitwise_the_redraw(cuda, ratio):
    """A CountSketch compress keeps the pair list of its one row-12b call;
    decompress gathers from it, drawing no pair (``SJLTOp._params`` raises), and
    its reconstruction is bitwise the operator's redraw adjoint on the card."""
    from repro_torch.core import gradcomp

    rs = np.random.default_rng(12)
    g = {"w": torch.from_numpy(rs.standard_normal(2**20).astype(np.float32)).to(cuda),
         "b": torch.from_numpy(rs.standard_normal(2**16).astype(np.float32)).to(cuda)}
    key = prng.prng_key(13)
    cfg = gradcomp.GradCompressionConfig(enabled=True, ratio=ratio)
    sops.LAUNCHES.clear()
    payload, ctx = gradcomp.compress(cfg, key, g)
    assert dict(sops.LAUNCHES) == {"sjlt_apply_long": 1}
    draws = operators.SJLTOp._params
    try:
        operators.SJLTOp._params = lambda *a, **k: pytest.fail("decompress drew the pairs again")
        rec = gradcomp.decompress(cfg, payload, ctx)
    finally:
        operators.SJLTOp._params = draws
    D = 2**20 + 2**16
    op = operators.make_operator(sketches.SketchSpec("sjlt", payload.shape[0], s=1, use_kernel=True), key, D,
                                 device=cuda)
    want = op.adjoint(payload)
    vec = torch.cat([rec["b"], rec["w"]])  # the tree's leaf order: sorted keys
    assert torch.equal(vec, want)
    assert torch.equal(payload, op.apply(torch.cat([g["b"], g["w"]])))


def test_gradient_compression_runs_its_kernels_on_the_card(cuda):
    """CountSketch: one long-column S·A call a compress, its payload within the
    measure of the plain version's; the Gaussian: one dense S·A and one adjoint
    that draws S again; each reconstruction against the CPU plain path."""
    from repro_torch.core import gradcomp

    rs = np.random.default_rng(8)
    g = {"w": torch.from_numpy(rs.standard_normal(2**16).astype(np.float32)),
         "b": torch.from_numpy(rs.standard_normal(2**12).astype(np.float32))}
    gc = {k: v.to(cuda) for k, v in g.items()}
    key = prng.prng_key(9)
    for kind, ratio, calls in (("countsketch", 0.1, {"sjlt_apply_long": 1}),
                               ("gaussian", 0.01, {"gaussian_sketch": 1, "gaussian_adjoint": 1})):
        cfg = gradcomp.GradCompressionConfig(enabled=True, ratio=ratio, kind=kind)
        sops.LAUNCHES.clear()
        gops.LAUNCHES.clear()
        payload, ctx = gradcomp.compress(cfg, key, gc)
        rec = gradcomp.decompress(cfg, payload, ctx)
        assert {**{k: v for k, v in sops.LAUNCHES.items() if v}, **{k: v for k, v in gops.LAUNCHES.items() if v}} == calls
        want_p, want_ctx = gradcomp.compress(cfg, key, g)
        want = gradcomp.decompress(cfg, want_p, want_ctx)
        for leaf in g:
            assert _sx_err(rec[leaf].cpu()[:, None], want[leaf][:, None]) <= 1e-4


def test_fit_head_and_row_sharded_workers_on_the_card(cuda):
    """fit_head's one multi-key Gram call against the CPU plain path (1e-4:
    d×d ridge solves of Grams that agree to 1e-5); the row-sharded worker mode
    one single-key Gram call a worker."""
    from repro_torch.train import solvers

    rs = np.random.default_rng(10)
    H = torch.from_numpy(rs.standard_normal((20_000, 24)).astype(np.float32))
    Y = H @ torch.from_numpy(rs.standard_normal((24, 3)).astype(np.float32))
    spec = sketches.SketchSpec("sjlt", 200, s=SJLT_S, use_kernel=True)
    sops.LAUNCHES.clear()
    W = solvers.fit_head(prng.prng_key(1), H.to(cuda), Y.to(cuda), spec, q=8)
    assert dict(sops.LAUNCHES) == {"sjlt_gram_multi": 1}
    want = solvers.fit_head(prng.prng_key(1), H, Y, spec, q=8, device="cpu")
    torch.testing.assert_close(W.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
    gops.LAUNCHES.clear()
    gauss = sketches.SketchSpec("gaussian", 200, use_kernel=True)
    x = distributed.distributed_sketch_solve(gauss, prng.prng_key(2), H.to(cuda), Y[:, 0].to(cuda), q=8,
                                             row_sharded=True)
    assert dict(gops.LAUNCHES) == {"gaussian_gram": 8}
    want = distributed.distributed_sketch_solve(gauss, prng.prng_key(2), H, Y[:, 0], q=8, row_sharded=True,
                                                device="cpu")
    torch.testing.assert_close(x.cpu(), want, rtol=1e-4, atol=1e-4 * float(want.abs().max()))
