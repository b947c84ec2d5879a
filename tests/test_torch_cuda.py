"""The port's CUDA kernels on the card: odd shapes, chunking, and Algorithm 1.

Marked ``gpu``: each test asks for the ``cuda`` fixture, which skips when no CUDA
device is present (the CPU tests cover the plain versions). On a machine with a
card run them with ``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_cuda.py``.

Kernel against plain version, per entry: max |ΔG_ij| / sqrt(G_ii·G_jj) ≤ 1e-5 over
the plain G (float32 sums of ≤ 4096 terms in two orders). Slices of a multi-key
launch are bitwise equal to single-key launches.
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
