"""Build the CUDA sources under ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` named in ``SOURCES`` is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into a shared library with a plain C interface, at first use,
into ``build/repro_torch_kernels/`` at the root of the checkout:

* ``sketch_gram`` — the dense sketch→Gram families (Gaussian, Rademacher, SRHT)
                    and the dense S·A (Gaussian, Rademacher);
* ``sjlt_gram``   — the sparse SJLT sketch→Gram and S·A;
* ``fwht``        — the fast Walsh-Hadamard transform;
* ``adjoint``     — the Gaussian adjoint Sᵀ·Y;
* ``rng_probe``   — the device counter RNG alone, for checking it bitwise.

The ``csrc/*.cuh`` headers (the RNG, the split reduction and Gram pass) are
included by the sources. A library's file name carries a hash of its source,
every header and the flags, so an edited source or header is rebuilt. All
sources are compiled in parallel, one ``nvcc`` each. Nothing here is imported
or built when a module of the port is imported: the CPU tests import every module
on a machine with no ``nvcc`` and no card.

There is no fallback: a missing ``nvcc``, a failed build or a refused launch raises.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels import common
from repro_torch.utils import env as envcfg

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("sketch_gram", "sjlt_gram", "fwht", "adjoint", "rng_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
FAMILIES = {"gaussian": 0, "rademacher": 1, "srht": 2}
# Sketch-pass block of csrc/sketch_gram.cu (BM sketch rows, BD columns, BK data
# rows per step). Only STEP_ROWS bears on correctness, and the C entry refuses a
# split that is not a multiple of it; the other two steer the split count.
BLOCK_ROWS, BLOCK_COLS, STEP_ROWS = 64, 256, 32
# Sketch-pass blocks a single-key launch aims for (a few waves of the card's
# SMs); fixed, so that n-splits depend on the shapes only (see plan_splits).
TARGET_BLOCKS = 2048
MIN_SPLIT_STEPS = 16
# Upper bound on the n-split partials one call into the C entry keeps; larger q
# is cut into chunks of workers, one call each.
SCRATCH_BYTES = 2 << 30
MAX_GRID_Z = 65535  # workers per call: the grid's z extent
# SJLT sketch pass of csrc/sjlt_gram.cu: a block owns at most SJLT_MAX_BUCKETS
# sketch rows (its shared-memory accumulator) and SJLT_BLOCK_COLS columns, and
# walks its rows in chunks of at most SJLT_MAX_CHUNK_ROWS rows and
# SJLT_MAX_PAIRS (row, t) pairs. SJLT_TARGET_BLOCKS (four waves of one block per
# SM) steers the n-splits: every split adds m·d floats per worker to the split
# reduction, so the SJLT takes far fewer splits than the dense families.
SJLT_BLOCK_COLS, SJLT_MAX_BUCKETS, SJLT_MAX_CHUNK_ROWS, SJLT_MAX_PAIRS = 32, 1536, 128, 2048
SJLT_TARGET_BLOCKS = 4 * 132
# FWHT passes of csrc/fwht.cu: a block holds 2**FWHT_MAX_TILE_BITS rows of 32
# columns (128 KB) in shared memory, so a pass runs at most that many stages.
FWHT_MAX_TILE_BITS = 10
# Gaussian adjoint of csrc/adjoint.cu: a block owns ADJOINT_ROWS output rows (one
# a thread), ADJOINT_COLS columns when k > 1 (all of k = 1 otherwise), and one
# split of the m sketch rows. The splits (plan_adjoint) aim for TARGET_BLOCKS
# blocks with at least ADJOINT_MIN_SPLIT_ROWS sketch rows each.
ADJOINT_ROWS, ADJOINT_COLS, ADJOINT_MIN_SPLIT_ROWS = 128, 8, 64

_LIBS: dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's -Xptxas -v report: registers, shared memory, spills


def nvcc_path() -> str:
    cuda_home = envcfg.read_raw("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        f"nvcc not found (looked in {cuda_home}/bin and on PATH): the CUDA kernels "
        "are built from csrc/ at first use and need the CUDA toolkit"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        if p.suffix == ".cuh" or p.stem == name:
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:12]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def nvcc_command(nvcc: str, name: str, out: Path) -> list[str]:
    return [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=SOURCES) -> list[Built]:
    """Build every named source that is not built yet, all ``nvcc`` at once."""
    todo = [n for n in names if not library_path(n).is_file()]
    done = [Built(n, 0.0, "") for n in names if n not in todo]
    if not todo:
        return done
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        proc = subprocess.Popen(
            nvcc_command(nvcc, name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        done.append(Built(name, seconds, log))
    if failures:
        raise RuntimeError("\n".join(failures))
    return done


def _library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _declare(name, lib)
        _LIBS[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, LL, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_uint
    lib.repro_error_string.argtypes = [I]
    lib.repro_error_string.restype = ctypes.c_char_p
    if name == "sketch_gram":
        lib.repro_sketch_gram.argtypes = [I, P, LL, I, P, P, I, I, F, I, LL, I, P, P, P]
        lib.repro_sketch_gram.restype = I
        lib.repro_sketch_apply.argtypes = [I, P, LL, I, P, I, I, F, I, LL, I, P, P, P]
        lib.repro_sketch_apply.restype = I
    elif name == "sjlt_gram":
        lib.repro_sjlt_gram.argtypes = [P, LL, I, P, I, I, I, F, LL, I, I, I, P, P, P]
        lib.repro_sjlt_gram.restype = I
        lib.repro_sjlt_apply.argtypes = [P, LL, I, P, I, I, I, F, LL, I, I, I, P, P, P]
        lib.repro_sjlt_apply.restype = I
    elif name == "fwht":
        lib.repro_fwht.argtypes = [P, P, LL, I, ctypes.POINTER(I), I, P]
        lib.repro_fwht.restype = I
    elif name == "adjoint":
        lib.repro_gaussian_adjoint.argtypes = [P, I, I, LL, U, U, F, I, I, I, P, P, P]
        lib.repro_gaussian_adjoint.restype = I
    elif name == "rng_probe":
        lib.repro_rng_probe.argtypes = [U, U, P, P, I, I, P, P, P, P]
        lib.repro_rng_probe.restype = I


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} ({lib.repro_error_string(code).decode()})")


def _u32_words(words: torch.Tensor, device: torch.device) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor with the same 32 bits."""
    w = words.to(torch.int64) & common.MASK32
    return torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).to(device).contiguous()


def plan_splits(n: int, m: int, d: int) -> tuple[int, int]:
    """``(n_splits, rows_per_split)`` for the sketch pass: enough blocks for a
    single key to fill the card, at least MIN_SPLIT_STEPS steps per split.
    A function of the shapes only, never of q: that keeps a worker's result
    bitwise the same whether it is launched alone or among q."""
    tiles = -(-m // BLOCK_ROWS) * -(-d // BLOCK_COLS)
    want = max(1, -(-TARGET_BLOCKS // tiles))
    most = max(1, -(-n // (STEP_ROWS * MIN_SPLIT_STEPS)))
    n_splits = min(want, most)
    rows = common.round_up(-(-n // n_splits), STEP_ROWS)
    return -(-n // rows), rows


@dataclasses.dataclass(frozen=True)
class SjltPlan:
    n_splits: int
    rows_per_split: int
    bucket_tile: int  # sketch rows per block (one m-tile)
    chunk_rows: int  # data rows a block takes per step


def plan_sjlt(n: int, m: int, d: int, s: int) -> SjltPlan:
    """The SJLT sketch pass's plan: m cut into balanced m-tiles of at most
    SJLT_MAX_BUCKETS rows, chunks of ``min(SJLT_MAX_CHUNK_ROWS, SJLT_MAX_PAIRS // s)``
    rows, and n cut into splits of whole chunks, enough for SJLT_TARGET_BLOCKS
    blocks at q = 1 but at least MIN_SPLIT_STEPS chunks each. Like
    :func:`plan_splits`, a function of the shapes only, never of q."""
    if not 0 < s <= SJLT_MAX_PAIRS:
        raise ValueError(f"the SJLT kernel takes 1 <= s <= {SJLT_MAX_PAIRS}, got s={s}")
    m_tiles = -(-m // SJLT_MAX_BUCKETS)
    bucket_tile = -(-m // m_tiles)
    chunk = min(SJLT_MAX_CHUNK_ROWS, SJLT_MAX_PAIRS // s)
    tiles = m_tiles * -(-d // SJLT_BLOCK_COLS)
    want = max(1, -(-SJLT_TARGET_BLOCKS // tiles))
    most = max(1, -(-n // (chunk * MIN_SPLIT_STEPS)))
    rows = common.round_up(-(-n // min(want, most)), chunk)
    return SjltPlan(-(-n // rows), rows, bucket_tile, chunk)


def _splits(family: str, n: int, m: int, d: int, s: int) -> int:
    return plan_sjlt(n, m, d, s).n_splits if family == "sjlt" else plan_splits(n, m, d)[0]


def worker_chunk(n: int, m: int, d: int, q: int, *, family: str = "gaussian", s: int = 0) -> int:
    """Workers per call into the C entry: a q-key Gram of X (n, d) makes
    ``ceil(q / worker_chunk(...))`` calls, each a sketch pass, a split reduction
    and a Gram pass over its chunk of workers. ``family`` (and ``s`` for the
    SJLT) picks the split plan: the dense families share one."""
    n_splits = _splits(family, n, m, d, s)
    return max(1, min(q, MAX_GRID_Z, SCRATCH_BYTES // (4 * n_splits * m * d)))


def _check_sketch_args(what: str, X: torch.Tensor, keys: torch.Tensor, m: int) -> tuple[int, int, int]:
    if X.device.type != "cuda":
        raise ValueError(f"{what} launches a CUDA kernel; X is on {X.device}")
    if X.dtype != torch.float32 or X.ndim != 2 or not X.is_contiguous():
        raise ValueError(
            f"X must be a contiguous 2-D float32 tensor, got {X.dtype} {tuple(X.shape)} "
            f"contiguous={X.is_contiguous()}"
        )
    if keys.ndim != 2 or keys.shape[1] != 2:
        raise ValueError(f"keys must be (q, 2) words, got shape {tuple(keys.shape)}")
    n, d = X.shape
    q = keys.shape[0]
    if not (0 < n < 2**32 and 0 < d and 0 < m < 2**31 and q > 0):
        raise ValueError(f"unsupported shape n={n} d={d} m={m} q={q}")
    return n, d, q


def sketch_gram(family: str, keys: torch.Tensor, X: torch.Tensor, m: int, *, rounds: int,
                launches: collections.Counter, name: str,
                srht_rows: torch.Tensor | None = None) -> torch.Tensor:
    """(q, d, d) Grams ``(S_w X)ᵀ(S_w X)`` of the CUDA tensor X for q key rows of a
    dense family. For ``"srht"`` the keys are the diagonal's words and
    ``srht_rows`` the (q, m) sampled Hadamard row ids. Adds one to
    ``launches[name]`` for each call into the C entry (one per chunk of workers,
    see :func:`worker_chunk`) that the card accepted."""
    n, d, q = _check_sketch_args("sketch_gram", X, keys, m)
    if rounds <= 0 or rounds % 4:
        raise ValueError(f"threefry rounds must be a positive multiple of 4, got {rounds}")
    if (family == "srht") != (srht_rows is not None):
        raise ValueError("srht_rows are given for the srht family, and only for it")
    if srht_rows is not None:
        if tuple(srht_rows.shape) != (q, m):
            raise ValueError(f"srht_rows must be (q, m) = ({q}, {m}), got {tuple(srht_rows.shape)}")
        srht_rows = _u32_words(srht_rows, X.device)
    lib = _library("sketch_gram")
    n_splits, rows = plan_splits(n, m, d)
    chunk = worker_chunk(n, m, d, q)
    kw = _u32_words(keys, X.device)
    G = torch.empty((q, d, d), dtype=torch.float32, device=X.device)
    partial = torch.empty((chunk, n_splits * m * d), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for w0 in range(0, q, chunk):
            qc = min(chunk, q - w0)
            code = lib.repro_sketch_gram(
                FAMILIES[family], X.data_ptr(), n, d, kw[w0].data_ptr(),
                None if srht_rows is None else srht_rows[w0].data_ptr(), qc, m,
                common.inv_sqrt(m), rounds, rows, n_splits, partial.data_ptr(), G[w0].data_ptr(),
                stream,
            )
            _check(lib, code, f"{family} sketch_gram launch")
            launches[name] += 1
    return G


def sjlt_gram(keys: torch.Tensor, X: torch.Tensor, m: int, s: int, *,
              launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, d, d) SJLT Grams ``(S_w X)ᵀ(S_w X)`` of the CUDA tensor X for q key rows,
    s nonzeros per data row. Adds one to ``launches[name]`` per call into the C
    entry (one per chunk of workers, see :func:`worker_chunk`)."""
    n, d, q = _check_sketch_args("sjlt_gram", X, keys, m)
    plan = plan_sjlt(n, m, d, s)
    lib = _library("sjlt_gram")
    chunk = worker_chunk(n, m, d, q, family="sjlt", s=s)
    kw = _u32_words(keys, X.device)
    G = torch.empty((q, d, d), dtype=torch.float32, device=X.device)
    partial = torch.empty((chunk, plan.n_splits * m * d), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for w0 in range(0, q, chunk):
            qc = min(chunk, q - w0)
            code = lib.repro_sjlt_gram(
                X.data_ptr(), n, d, kw[w0].data_ptr(), qc, m, s, common.inv_sqrt(s),
                plan.rows_per_split, plan.n_splits, plan.bucket_tile, plan.chunk_rows,
                partial.data_ptr(), G[w0].data_ptr(), stream,
            )
            _check(lib, code, "sjlt_gram launch")
            launches[name] += 1
    return G


def sketch_apply(family: str, keys: torch.Tensor, X: torch.Tensor, m: int, *, rounds: int,
                 launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, m, d) sketches ``S_w X`` of the CUDA tensor X for q key rows of the
    Gaussian or Rademacher family: the Gram kernel's sketch pass and split
    reduction on the same plan (:func:`plan_splits`), so slice w is bitwise the
    S_w X that ``sketch_gram`` forms G_w from, and bitwise a q = 1 call. Adds one
    to ``launches[name]`` per call into the C entry (one per chunk of workers)."""
    n, d, q = _check_sketch_args("sketch_apply", X, keys, m)
    if family not in ("gaussian", "rademacher"):
        raise ValueError(f"the dense S·A kernel takes the gaussian and rademacher families, got {family!r}")
    if rounds <= 0 or rounds % 4:
        raise ValueError(f"threefry rounds must be a positive multiple of 4, got {rounds}")
    lib = _library("sketch_gram")
    n_splits, rows = plan_splits(n, m, d)
    chunk = worker_chunk(n, m, d, q)
    kw = _u32_words(keys, X.device)
    out = torch.empty((q, m, d), dtype=torch.float32, device=X.device)
    partial = torch.empty((chunk, n_splits * m * d), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for w0 in range(0, q, chunk):
            qc = min(chunk, q - w0)
            code = lib.repro_sketch_apply(
                FAMILIES[family], X.data_ptr(), n, d, kw[w0].data_ptr(), qc, m,
                common.inv_sqrt(m), rounds, rows, n_splits, partial.data_ptr(), out[w0].data_ptr(),
                stream,
            )
            _check(lib, code, f"{family} sketch_apply launch")
            launches[name] += 1
    return out


def sjlt_apply(keys: torch.Tensor, X: torch.Tensor, m: int, s: int, *,
               launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, m, d) SJLT sketches ``S_w X`` of the CUDA tensor X for q key rows, s
    nonzeros per data row: the SJLT Gram kernel's sketch pass and split reduction
    on its plan (:func:`plan_sjlt`). Adds one to ``launches[name]`` per call into
    the C entry (one per chunk of workers)."""
    n, d, q = _check_sketch_args("sjlt_apply", X, keys, m)
    plan = plan_sjlt(n, m, d, s)
    lib = _library("sjlt_gram")
    chunk = worker_chunk(n, m, d, q, family="sjlt", s=s)
    kw = _u32_words(keys, X.device)
    out = torch.empty((q, m, d), dtype=torch.float32, device=X.device)
    partial = torch.empty((chunk, plan.n_splits * m * d), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for w0 in range(0, q, chunk):
            qc = min(chunk, q - w0)
            code = lib.repro_sjlt_apply(
                X.data_ptr(), n, d, kw[w0].data_ptr(), qc, m, s, common.inv_sqrt(s),
                plan.rows_per_split, plan.n_splits, plan.bucket_tile, plan.chunk_rows,
                partial.data_ptr(), out[w0].data_ptr(), stream,
            )
            _check(lib, code, "sjlt_apply launch")
            launches[name] += 1
    return out


def plan_fwht(n: int) -> tuple[int, ...]:
    """Stages per pass of the FWHT of length n (a power of two): log2(n) stages
    cut into the fewest passes of at most FWHT_MAX_TILE_BITS, as even as they
    go, larger first (one pass of 0 stages, a copy, for n = 1). Pass p runs the
    stages h = 2**lo .. 2**(lo + t_p − 1), lo the stages before it, in order."""
    if n <= 0 or n & (n - 1):
        raise ValueError(f"FWHT needs a power-of-two length, got {n}")
    log_n = n.bit_length() - 1
    passes = max(1, -(-log_n // FWHT_MAX_TILE_BITS))
    base, extra = divmod(log_n, passes)
    return tuple(base + (p < extra) for p in range(passes))


def fwht(x: torch.Tensor, *, launches: collections.Counter, name: str) -> torch.Tensor:
    """H·x for the CUDA tensor x (n, k) float32, contiguous, n a power of two, in
    the passes of :func:`plan_fwht` (the first reads x, the rest work in place
    on the result). Adds one to ``launches[name]`` per call into the C entry."""
    if x.device.type != "cuda":
        raise ValueError(f"fwht launches a CUDA kernel; x is on {x.device}")
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            f"x must be a contiguous 2-D float32 tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}"
        )
    n, k = x.shape
    if not (0 < k < 2**31 and n * k < 2**62):
        raise ValueError(f"unsupported shape n={n} k={k}")
    plan = plan_fwht(n)
    lib = _library("fwht")
    bits = (ctypes.c_int * len(plan))(*plan)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        code = lib.repro_fwht(x.data_ptr(), y.data_ptr(), n, k, bits, len(plan),
                              torch.cuda.current_stream(x.device).cuda_stream)
    _check(lib, code, "fwht launch")
    launches[name] += 1
    return y


def plan_adjoint(m: int, n: int, k: int) -> tuple[int, int]:
    """``(n_splits, rows_per_split)`` of the m sketch rows for the Gaussian adjoint
    of Y (m, k) into (n, k): enough blocks of ADJOINT_ROWS output rows to fill the
    card, at least ADJOINT_MIN_SPLIT_ROWS rows a split (unless m is smaller), no
    split empty. A function of the shapes only, so reruns add the same partials
    in the same order."""
    tiles = -(-n // ADJOINT_ROWS) * -(-k // ADJOINT_COLS)
    want = max(1, -(-TARGET_BLOCKS // tiles))
    most = max(1, m // ADJOINT_MIN_SPLIT_ROWS)
    rows = -(-m // min(want, most))
    return -(-m // rows), rows


def gaussian_adjoint(key: torch.Tensor, Y: torch.Tensor, n: int, *, rounds: int,
                     launches: collections.Counter, name: str) -> torch.Tensor:
    """Sᵀ·Y (n, k) for the CUDA tensor Y (m, k) float32, contiguous, and S ∈ R^{m×n}
    with S[i, j] = counter_normal(key, i, j)/√m (the forward S·A's S). Adds one to
    ``launches[name]`` per call into the C entry (its partial pass and split
    reduction, :func:`plan_adjoint`)."""
    if Y.device.type != "cuda":
        raise ValueError(f"gaussian_adjoint launches a CUDA kernel; Y is on {Y.device}")
    if Y.dtype != torch.float32 or Y.ndim != 2 or not Y.is_contiguous():
        raise ValueError(
            f"Y must be a contiguous 2-D float32 tensor, got {Y.dtype} {tuple(Y.shape)} "
            f"contiguous={Y.is_contiguous()}"
        )
    m, k = Y.shape
    if not (0 < m < 2**31 and 0 < k <= MAX_GRID_Z * ADJOINT_COLS and 0 < n < 2**31):
        raise ValueError(f"unsupported shape m={m} k={k} n={n}")
    if rounds <= 0 or rounds % 4:
        raise ValueError(f"threefry rounds must be a positive multiple of 4, got {rounds}")
    k0, k1 = common.key_words(key)
    n_splits, rows = plan_adjoint(m, n, k)
    lib = _library("adjoint")
    out = torch.empty((n, k), dtype=torch.float32, device=Y.device)
    partial = torch.empty((n_splits, n, k), dtype=torch.float32, device=Y.device)
    with torch.cuda.device(Y.device):
        code = lib.repro_gaussian_adjoint(
            Y.data_ptr(), m, k, n, k0, k1, common.inv_sqrt(m), rounds, rows, n_splits,
            partial.data_ptr(), out.data_ptr(), torch.cuda.current_stream(Y.device).cuda_stream,
        )
    _check(lib, code, "gaussian_adjoint launch")
    launches[name] += 1
    return out


def rng_probe(k0: int, k1: int, c0: torch.Tensor, c1: torch.Tensor, *, rounds: int):
    """Device threefry words (count, 2), normals and packed signs for the counter
    pairs (c0, c1) (int64 tensors of uint32 values); see ``csrc/rng_probe.cu``."""
    lib = _library("rng_probe")
    dev = torch.device("cuda")
    a, b = _u32_words(c0.reshape(-1), dev), _u32_words(c1.reshape(-1), dev)
    count = a.numel()
    words = torch.empty((count, 2), dtype=torch.int32, device=dev)
    normals = torch.empty(count, dtype=torch.float32, device=dev)
    signs = torch.empty(count, dtype=torch.float32, device=dev)
    code = lib.repro_rng_probe(
        k0, k1, a.data_ptr(), b.data_ptr(), count, rounds, words.data_ptr(),
        normals.data_ptr(), signs.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
    _check(lib, code, "rng_probe launch")
    return words.to(torch.int64) & common.MASK32, normals, signs
