"""Build the CUDA sources under ``csrc/`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` named in ``SOURCES`` is compiled by ``nvcc`` for
``sm_90a`` (Hopper) into a shared library with a plain C interface, at first use,
into ``build/repro_torch_kernels/`` at the root of the checkout:

* ``sketch_gram`` — the dense sketch→Gram families (Gaussian, Rademacher, SRHT),
  one sketch pass on the tensor cores (``repro_dense_gram``);
* ``sketch_apply`` — the dense S·A (Gaussian, Rademacher) on the tensor cores;
* ``sjlt_gram``   — the sparse SJLT sketch→Gram and S·A (a bin pass and a scatter pass),
  and the S·A of few, long columns (row 12b: the pairs partitioned by bucket range,
  fixed-point sums in shared memory);
* ``fwht``        — the fast Walsh-Hadamard transform, and the SRHT's S·A on it
  (the diagonal at its first pass's loads, only the sampled rows written by its last);
* ``adjoint``     — the Gaussian adjoint Sᵀ·Y: over an S the forward S·A kept
  (``repro_adjoint_kept``), or with S drawn again (``repro_gaussian_adjoint``);
* ``rng_probe``   — the device counter RNG alone, for checking it bitwise;
* ``mma_probe``   — the dense S·A's TF32 tensor-core product alone: one warp's
  fragments against float64, and ``mma.sync``'s own rate.

The ``csrc/*.cuh`` headers (the RNG, the TF32 product, the mbarrier and bulk-copy
pipeline, the split reduction and Gram pass) are included by the sources. A
library's file name carries a hash of its source, every header and the flags, so
an edited source or header is rebuilt. All
sources are compiled in parallel, one ``nvcc`` each. Nothing here is imported
or built when a module of the port is imported: the CPU tests import every module
on a machine with no ``nvcc`` and no card.

There is no fallback: a missing ``nvcc``, a failed build or a refused launch raises.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import math
import os
import re
import shutil
import subprocess
import threading
import time
from collections.abc import Callable
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import common
from repro_torch.utils import env as envcfg

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("sketch_gram", "sketch_apply", "sjlt_gram", "fwht", "adjoint", "rng_probe", "mma_probe")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
FAMILIES = {"gaussian": 0, "rademacher": 1, "srht": 2}
DENSE_GRAMS = tuple(FAMILIES)  # the families of csrc/sketch_gram.cu's one sketch pass
# Data rows a step of the dense sketch passes (one packed sign word); the C
# entries refuse a split that is not a whole number of steps.
STEP_ROWS = 32
# Sketch-pass blocks a single-key launch aims for (a few waves of the card's
# SMs); fixed, so that n-splits depend on the shapes only (see plan_dense_gram).
TARGET_BLOCKS = 2048
# Dense sketch→Gram pass of csrc/sketch_gram.cu: a block owns GRAM_BLOCK_ROWS
# sketch rows (an m-tile) and one of GRAM_BLOCK_COLS column widths and walks its
# split GRAM_STEP_ROWS data rows a step; the m-tiles of one column tile form
# clusters of at most GRAM_MAX_CLUSTER blocks that read each X tile once.
# Clusters of 2: at FIG3A on an H100 (tools/gram_ablation.py --max-cluster) the
# Gaussian's clusters of 1 and 2 took the same time and 4 and 8 took 12-13% more
# (8 leave 12 of 132 SMs idle).
GRAM_BLOCK_ROWS, GRAM_BLOCK_COLS, GRAM_STEP_ROWS, GRAM_MAX_CLUSTER = 64, (64, 128, 256), 32, 2
MIN_SPLIT_STEPS = 16
# Upper bound on the n-split partials one call into the C entry keeps; larger q
# is cut into chunks of workers, one call each.
SCRATCH_BYTES = 2 << 30
MAX_GRID_Z = 65535  # workers per call: the grid's z extent
MAX_GRID_Y = 65535  # n-splits of one launch: the grid's y extent
# Dense S·A of csrc/sketch_apply.cu: a block owns APPLY_BLOCK_ROWS sketch rows and
# one of APPLY_BLOCK_COLS column widths; its split is a whole number of STEP_ROWS
# (packed sign words; the C entry refuses another split). The column tiles of one
# m-tile form clusters of at most APPLY_MAX_CLUSTER blocks that draw each S entry
# once. APPLY_TARGET_BLOCKS (four waves of one block per SM) steers the n-splits
# (plan_apply).
APPLY_BLOCK_ROWS, APPLY_BLOCK_COLS, APPLY_MAX_CLUSTER = 64, (64, 128, 256), 8
APPLY_TARGET_BLOCKS = 4 * 132
# SJLT passes of csrc/sjlt_gram.cu. The bin pass draws each chunk of at most
# SJLT_MAX_CHUNK_ROWS data rows and SJLT_MAX_PAIRS (row, t) pairs once and writes
# its pairs binned by (m-tile, owner class); the scatter pass's block owns
# SJLT_BLOCK_COLS columns and an m-tile of sketch rows, its accumulator in shared
# memory (SJLT_SMEM bytes a block, beside a ring of SJLT_STAGES chunks of list
# and X rows), and SJLT_CLASSES owner classes (a half-warp of a consumer warp
# each); at most SJLT_MAX_BINS (m-tile, class) bins, and an entry addresses at
# most SJLT_MAX_ACC accumulator floats. SJLT_TARGET_BLOCKS (four waves of one
# block per SM) steers the n-splits: every split adds m·d floats per worker to
# the split reduction.
SJLT_BLOCK_COLS, SJLT_CLASSES, SJLT_STAGES = 32, 32, 4
SJLT_MAX_CHUNK_ROWS, SJLT_MAX_PAIRS, SJLT_MAX_BINS, SJLT_MAX_ACC = 64, 2048, 1024, 1 << 16
SJLT_SMEM = 232_448
SJLT_TARGET_BLOCKS = 4 * 132
# Row 12b, csrc/sjlt_gram.cu repro_sjlt_apply_long: the SJLT S·A for at most
# SJLT_LONG_MAX_COLS columns (one scatter block's 32 columns would leave most
# lanes idle) or an m past plan_sjlt's m-tiles (plan_sjlt_long). Its scatter
# blocks place SJLT_LONG_TILE pairs a step (SJLT_LONG_LIST_TILE entries of the
# group list); its first-level count and scatter blocks take chunks of whole
# SJLT_LONG_TILE pairs, about
# SJLT_LONG_CHUNKS of them (six blocks on each of 132 SMs); a partition holds
# at most the buckets whose sums fit an accumulate block's SJLT_LONG_ACC_SMEM
# bytes (two blocks an SM), the partitions a multiple of SJLT_LONG_TARGET_BLOCKS
# (whole waves; fewer, of one bucket each, where m is smaller). Past
# SJLT_LONG_ONE_LEVEL_PARTS partitions and SJLT_LONG_ONE_LEVEL_PAIRS pairs (or
# past SJLT_LONG_MAX_BINS partitions, a pass's most) the pairs are sorted in two
# levels, through groups of about sqrt(partitions) partitions. More than
# SJLT_LONG_GROUP_COLS columns are summed a group at a time.
SJLT_LONG_MAX_COLS = 8
SJLT_LONG_TILE = 1024
SJLT_LONG_LIST_TILE = 2048
SJLT_LONG_CHUNKS = 6 * 132
SJLT_LONG_ACC_SMEM = 115_712
SJLT_LONG_MAX_BINS = 2048
SJLT_LONG_TARGET_BLOCKS = 2 * 132
SJLT_LONG_ONE_LEVEL_PARTS = 128
SJLT_LONG_ONE_LEVEL_PAIRS = 1 << 22
SJLT_LONG_GROUP_COLS = 8
# FWHT passes of csrc/fwht.cu: a block holds 2**FWHT_MAX_TILE_BITS rows of a
# column strip in shared memory, so a pass runs at most that many stages. The
# SRHT forward's scratch between its passes has rows of whole
# FWHT_SCRATCH_ALIGN floats (csrc/fwht.cu SCRATCH_ALIGN; the C entry refuses
# another row length).
FWHT_MAX_TILE_BITS = 10
FWHT_SCRATCH_ALIGN = 32
# Gaussian adjoints of csrc/adjoint.cu. The redraw kernel's block owns
# ADJOINT_ROWS output rows (one a thread), ADJOINT_COLS columns when k > 1 (all
# of k = 1 otherwise) and one split of the m sketch rows; the kept-S kernel's
# cluster owns a strip of ADJOINT_ROWS output rows (four a lane), ADJOINT_KEPT_COLS
# columns when k > 1, and every split, one a warp, ADJOINT_SPLITS_PER_BLOCK a
# block. Both take the splits of plan_adjoint: about ADJOINT_TARGET_WARPS strips
# times splits, whole blocks of splits, at most ADJOINT_MAX_SPLITS (one cluster
# of 8 blocks), at least ADJOINT_MIN_SPLIT_ROWS rows each. The kept S has rows
# of whole KEPT_ROW_ALIGN floats (16 bytes).
ADJOINT_ROWS, ADJOINT_COLS, ADJOINT_MIN_SPLIT_ROWS = 128, 8, 64
ADJOINT_KEPT_COLS, ADJOINT_SPLITS_PER_BLOCK, ADJOINT_MAX_SPLITS, ADJOINT_TARGET_WARPS = 4, 8, 64, 2048
KEPT_ROW_ALIGN = 4

_LIBS: dict[str, ctypes.CDLL] = {}
# Kernel wrappers are called from several host threads at once (the runtime's
# thread backend): one lock makes a library's check, build and load happen once,
# another makes each launch counter's read-modify-write whole.
_LIBS_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


@dataclasses.dataclass(frozen=True)
class Built:
    name: str
    seconds: float  # 0.0 when the library was already built
    log: str  # nvcc's -Xptxas -v report: registers, shared memory, spills


def ptxas_usage(log: str) -> list[dict]:
    """Per kernel of an ``nvcc -Xptxas -v`` log: its name (demangled where
    ``c++filt`` is found), registers, stack frame and spill bytes."""
    rows: list[dict] = []
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '(\w+)'", line):
            rows.append({"kernel": m.group(1)})
        elif rows and (m := re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                                      line)):
            rows[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)), spill_loads=int(m.group(3)))
        elif rows and (m := re.search(r"Used (\d+) registers", line)):
            rows[-1]["registers"] = int(m.group(1))
    if rows and (filt := shutil.which("c++filt")):
        out = subprocess.run([filt], input="\n".join(r["kernel"] for r in rows), capture_output=True, text=True)
        for r, name in zip(rows, out.stdout.splitlines()):
            r["kernel"] = re.sub(r"^void |\(anonymous namespace\)::|repro::|\(.*", "", name)
    return rows


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


def _tmp_name(out: Path) -> Path:
    """Where one build writes ``out`` before moving it in place: a file of its own
    for each process and thread, so concurrent builds never write one file."""
    return out.with_name(f"{out.name}.tmp{os.getpid()}-{threading.get_ident()}")


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
        tmp = _tmp_name(out)
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
    if lib is not None:
        return lib
    with _LIBS_LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _declare(name, lib)
            _LIBS[name] = lib
    return lib


def count_launch(launches: collections.Counter, name: str) -> None:
    """Add one to ``launches[name]``, whole under concurrent callers."""
    with _COUNT_LOCK:
        launches[name] += 1


def _declare(name: str, lib: ctypes.CDLL) -> None:
    P, I, LL, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float, ctypes.c_uint
    lib.repro_error_string.argtypes = [I]
    lib.repro_error_string.restype = ctypes.c_char_p
    if name == "sketch_gram":
        lib.repro_dense_gram.argtypes = [I, P, LL, I, P, P, I, I, F, I, LL, I, I, I, I, P, LL, I, P, P, P]
        lib.repro_dense_gram.restype = I
        lib.repro_dense_gram_clusters.argtypes = [I, I, I, ctypes.POINTER(I)]
        lib.repro_dense_gram_clusters.restype = I
    elif name == "sketch_apply":
        lib.repro_sketch_apply.argtypes = [I, P, LL, I, P, I, I, F, I, LL, I, I, I, I, P, P, P, LL, LL, P]
        lib.repro_sketch_apply.restype = I
        lib.repro_sketch_apply_clusters.argtypes = [I, I, ctypes.POINTER(I)]
        lib.repro_sketch_apply_clusters.restype = I
    elif name == "sjlt_gram":
        lib.repro_sjlt_gram.argtypes = [P, LL, I, P, I, I, I, F, LL, I, I, I, P, P, P, P]
        lib.repro_sjlt_gram.restype = I
        lib.repro_sjlt_apply.argtypes = [P, LL, I, P, I, I, I, F, LL, I, I, I, P, P, P, LL, P]
        lib.repro_sjlt_apply.restype = I
        lib.repro_sjlt_bins.argtypes = [LL, I, P, I, I, I, LL, I, I, I, P, P]
        lib.repro_sjlt_bins.restype = I
        W = ctypes.POINTER(ctypes.c_uint32)
        lib.repro_sjlt_apply_long.argtypes = [P, LL, I, W, I, I, I, F, LL, I, I, I, LL, I, P, P, LL, P, P]
        lib.repro_sjlt_apply_long.restype = I
        lib.repro_sjlt_long_scratch_bytes.argtypes = [LL, I, I, I, I, I, I, LL, I]
        lib.repro_sjlt_long_scratch_bytes.restype = LL
        lib.repro_sjlt_long_partition.argtypes = [P, LL, I, W, I, I, LL, I, I, I, LL, I, P, P, P, P, P, LL, P]
        lib.repro_sjlt_long_partition.restype = I
    elif name == "fwht":
        lib.repro_fwht.argtypes = [P, P, LL, I, LL, I, I, P]
        lib.repro_fwht.restype = I
        lib.repro_srht_forward.argtypes = [P, LL, I, U, U, P, I, F, P, P, LL, LL, LL, I, I, P]
        lib.repro_srht_forward.restype = I
    elif name == "adjoint":
        lib.repro_gaussian_adjoint.argtypes = [P, I, I, LL, U, U, F, I, I, I, P, P, P]
        lib.repro_gaussian_adjoint.restype = I
        lib.repro_adjoint_kept.argtypes = [P, LL, P, I, I, LL, I, I, P, I, P]
        lib.repro_adjoint_kept.restype = I
    elif name == "rng_probe":
        lib.repro_rng_probe.argtypes = [U, U, P, P, I, I, P, P, P, P]
        lib.repro_rng_probe.restype = I
    elif name == "mma_probe":
        lib.repro_mma_probe.argtypes = [P, P, P, P, P]
        lib.repro_mma_probe.restype = I
        lib.repro_mma_rate.argtypes = [I, I, P, P]
        lib.repro_mma_rate.restype = I


def _check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} ({lib.repro_error_string(code).decode()})")


def _u32_words(words: torch.Tensor, device: torch.device) -> torch.Tensor:
    """int64 tensor of uint32 values -> int32 tensor on ``device`` with the same
    32 bits. Words on the host are converted there and reach the card through
    pinned memory with a copy that does not wait for the card."""
    w = words.to(torch.int64) & common.MASK32
    w = torch.where(w >= 2**31, w - 2**32, w).to(torch.int32).contiguous()
    if w.device.type == "cpu" and device.type == "cuda":
        w = w.pin_memory()
    return w.to(device, non_blocking=True)


def _split_rows(n: int, blocks_per_split: int) -> tuple[int, int]:
    """``(n_splits, rows_per_split)`` of n data rows for a sketch pass that runs
    ``blocks_per_split`` blocks a split: enough splits for TARGET_BLOCKS blocks at
    q = 1, each at least MIN_SPLIT_STEPS whole STEP_ROWS steps (unless n is
    smaller), none empty."""
    want = max(1, -(-TARGET_BLOCKS // blocks_per_split))
    most = max(1, -(-n // (STEP_ROWS * MIN_SPLIT_STEPS)))
    rows = common.round_up(-(-n // min(want, most, MAX_GRID_Y)), STEP_ROWS)
    return -(-n // rows), rows


@dataclasses.dataclass(frozen=True)
class GramPlan:
    """The dense sketch→Gram pass's plan (:func:`plan_dense_gram`)."""
    n_splits: int
    rows_per_split: int
    block_cols: int  # BN, columns per block
    d_tiles: int  # column tiles: ceil(d / block_cols)
    m_tiles: int  # m-tiles of GRAM_BLOCK_ROWS sketch rows
    cluster: int  # blocks per cluster: m-tiles that share each X tile
    clusters: int  # clusters per column tile; the last may hold m-tiles past m
    x_rows: int  # rows of the split form of X: n up to a whole step

    @property
    def grid_x(self) -> int:
        return self.d_tiles * self.clusters * self.cluster

    @property
    def blocks(self) -> int:
        """Blocks a single-key launch runs."""
        return self.grid_x * self.n_splits

    @property
    def xs_floats(self) -> int:
        """Floats of the split form of X (hi and lo, padded to whole column tiles)."""
        return 2 * self.d_tiles * self.block_cols * self.x_rows


@functools.lru_cache(maxsize=256)
def plan_dense_gram(n: int, m: int, d: int) -> GramPlan:
    """The dense sketch→Gram plan of X (n, d) at m sketch rows, the same for the
    Gaussian, Rademacher and SRHT. The column
    width is the narrowest of GRAM_BLOCK_COLS that holds d (the widest past it),
    so that for d <= 256 one column tile draws each S entry once per split. The
    m-tiles of a column tile form ``clusters`` clusters of ``cluster`` <=
    GRAM_MAX_CLUSTER blocks, as even as they go (fewer than ``clusters`` padding
    m-tiles), each reading an X tile once for all its blocks. The n-splits
    (whole STEP_ROWS steps) aim for TARGET_BLOCKS blocks at q = 1. A function of
    the shapes only, never of q, so a worker's Gram is bitwise the same launched
    alone or among q."""
    bn = next((b for b in GRAM_BLOCK_COLS if b >= d), GRAM_BLOCK_COLS[-1])
    d_tiles = -(-d // bn)
    m_tiles = -(-m // GRAM_BLOCK_ROWS)
    clusters = -(-m_tiles // GRAM_MAX_CLUSTER)
    cluster = -(-m_tiles // clusters)
    n_splits, rows = _split_rows(n, d_tiles * clusters * cluster)
    return GramPlan(n_splits, rows, bn, d_tiles, m_tiles, cluster, clusters, common.round_up(n, GRAM_STEP_ROWS))


@dataclasses.dataclass(frozen=True)
class SjltPlan:
    """The SJLT passes' plan (:func:`plan_sjlt`)."""
    n_splits: int
    rows_per_split: int  # whole chunks
    chunk_rows: int  # data rows a chunk: one bin-pass warp, one ring entry
    pairs: int  # (row, t) pairs a full chunk: chunk_rows * s
    bucket_tile: int  # sketch rows a scatter block (one m-tile)
    m_tiles: int
    d_tiles: int  # ceil(d / SJLT_BLOCK_COLS)
    chunks: int  # ceil(n / chunk_rows)

    @property
    def bins(self) -> int:
        return self.m_tiles * SJLT_CLASSES

    @property
    def spare_row(self) -> int:
        """The first of the accumulator's SJLT_CLASSES spare rows, which the pads
        of the bins (to whole 4-entry groups) add into: bucket_tile up to a whole
        number of classes, so spare row spare_row + c is in class c."""
        return common.round_up(self.bucket_tile, SJLT_CLASSES)

    @property
    def hdr_ints(self) -> int:
        """Words of a chunk's bin offsets (bins + 1, to a whole 16 bytes)."""
        return common.round_up(self.bins + 1, 4)

    @property
    def region_ints(self) -> int:
        """Words of a chunk's list region: its bin offsets, then its entries
        (each bin padded to a multiple of 4)."""
        return _sjlt_region_ints(self.bins, self.pairs)

    @property
    def list_ints(self) -> int:
        """Words of one worker's binned pair list."""
        return self.chunks * self.region_ints

    @property
    def smem_bytes(self) -> int:
        """Shared memory of a scatter block: the ring, its barriers, the accumulator."""
        return _sjlt_smem(self.region_ints, self.chunk_rows, self.bucket_tile)

    @property
    def blocks(self) -> int:
        """Scatter blocks a single-key launch runs."""
        return self.d_tiles * self.m_tiles * self.n_splits


def _sjlt_region_ints(bins: int, pairs: int) -> int:
    return common.round_up(bins + 1, 4) + common.round_up(pairs + 3 * bins, 4)


def _sjlt_acc_floats(bucket_tile: int) -> int:
    """Accumulator floats of a scatter block: the m-tile's rows up to a whole
    number of classes, then the SJLT_CLASSES spare rows."""
    return (common.round_up(bucket_tile, SJLT_CLASSES) + SJLT_CLASSES) * SJLT_BLOCK_COLS


def _sjlt_smem(region_ints: int, chunk_rows: int, bucket_tile: int) -> int:
    """Shared-memory bytes of a scatter block: the ring of list regions and
    staged X rows, its barriers, and the accumulator."""
    return (SJLT_STAGES * (4 * region_ints + 4 * SJLT_BLOCK_COLS * chunk_rows) + 16 * SJLT_STAGES
            + 4 * _sjlt_acc_floats(bucket_tile))


def _sjlt_fits(m_tiles: int, bucket_tile: int, chunk_rows: int, pairs: int) -> bool:
    """Whether a scatter block of bucket_tile rows fits its shared memory and
    its entries can address every accumulator row."""
    region = _sjlt_region_ints(m_tiles * SJLT_CLASSES, pairs)
    return (_sjlt_acc_floats(bucket_tile) <= SJLT_MAX_ACC
            and _sjlt_smem(region, chunk_rows, bucket_tile) <= SJLT_SMEM)


def _sjlt_m_tiles(m: int, chunk_rows: int, pairs: int) -> int | None:
    """The fewest balanced m-tiles of m sketch rows whose scatter block fits, or None."""
    return next((t for t in range(1, SJLT_MAX_BINS // SJLT_CLASSES + 1)
                 if _sjlt_fits(t, -(-m // t), chunk_rows, pairs)), None)


def sjlt_apply_is_long(n: int, m: int, d: int, s: int) -> bool:
    """Whether the SJLT S·A of X (n, d) at m rows takes row 12b
    (:func:`sjlt_apply_long`) rather than the bin and scatter passes: for at most
    SJLT_LONG_MAX_COLS columns, or an m that :func:`plan_sjlt`'s m-tiles cannot
    hold (m > 31,744 at s = 1). A function of the shapes only, so a key's S·X
    takes the same entry alone or among q."""
    if d <= SJLT_LONG_MAX_COLS:
        return True
    if not 0 < s <= SJLT_MAX_PAIRS:
        return False  # plan_sjlt refuses it by its s
    chunk_rows = min(SJLT_MAX_CHUNK_ROWS, SJLT_MAX_PAIRS // s)
    return _sjlt_m_tiles(m, chunk_rows, chunk_rows * s) is None


@functools.lru_cache(maxsize=256)
def plan_sjlt(n: int, m: int, d: int, s: int) -> SjltPlan:
    """The SJLT passes' plan: chunks of ``min(SJLT_MAX_CHUNK_ROWS, SJLT_MAX_PAIRS // s)``
    rows; m cut into the fewest balanced m-tiles whose scatter block fits (two
    at FIG3A's m = 2,500, adjacent in the grid, so the second reads X from L2);
    n cut into splits of whole chunks, as few as one, enough for
    SJLT_TARGET_BLOCKS scatter blocks at q = 1. Like :func:`plan_dense_gram`, a
    function of the shapes only, never of q. Raises ValueError for an s or m the
    kernels cannot take."""
    if not 0 < s <= SJLT_MAX_PAIRS:
        raise ValueError(f"the SJLT kernel takes 1 <= s <= {SJLT_MAX_PAIRS}, got s={s}")
    chunk_rows = min(SJLT_MAX_CHUNK_ROWS, SJLT_MAX_PAIRS // s)
    pairs = chunk_rows * s
    m_tiles = _sjlt_m_tiles(m, chunk_rows, pairs)
    if m_tiles is None:
        raise ValueError(f"the SJLT kernel's {SJLT_MAX_BINS} bins cannot hold m={m} sketch rows")
    chunks = -(-n // chunk_rows)
    d_tiles = -(-d // SJLT_BLOCK_COLS)
    want = -(-SJLT_TARGET_BLOCKS // (d_tiles * m_tiles))
    per_split = -(-chunks // max(1, min(want, chunks, MAX_GRID_Y)))
    return SjltPlan(-(-chunks // per_split), per_split * chunk_rows, chunk_rows, pairs, -(-m // m_tiles), m_tiles,
                    d_tiles, chunks)


@dataclasses.dataclass(frozen=True)
class ApplyPlan:
    n_splits: int
    rows_per_split: int
    block_rows: int  # BM, sketch rows per block
    block_cols: int  # BN, columns per block
    cluster: int  # blocks per cluster: column tiles that share each drawn S tile
    groups: int  # clusters per m-tile: ceil(column tiles / cluster)
    m_tiles: int

    @property
    def grid_x(self) -> int:
        return self.m_tiles * self.groups * self.cluster

    @property
    def blocks(self) -> int:
        """Blocks a single-key launch runs."""
        return self.grid_x * self.n_splits

    @property
    def direct(self) -> bool:
        """One split: the kernel writes S·X itself, no partials, no reduction."""
        return self.n_splits == 1


def plan_apply(n: int, m: int, d: int) -> ApplyPlan:
    """The dense S·A plan of X (n, d) at m sketch rows. The column width is the
    one of APPLY_BLOCK_COLS that pads d least among those that need at most
    APPLY_MAX_CLUSTER column tiles (ties to the wider; 256 past 8 tiles). The
    tiles of one m-tile form ``groups`` clusters of ``cluster`` blocks, as even
    as they go, so each S entry is drawn ``groups`` times per split. The n-splits
    (whole STEP_ROWS steps, as few as one step each) aim for APPLY_TARGET_BLOCKS
    blocks and keep one worker's partials within SCRATCH_BYTES. A function of the
    shapes only, never of q, so a worker's S·X is bitwise the same launched alone
    or among q."""
    return _plan_apply(n, m, d, SCRATCH_BYTES)


@functools.lru_cache(maxsize=256)
def _plan_apply(n: int, m: int, d: int, scratch_bytes: int) -> ApplyPlan:
    fits = [bn for bn in APPLY_BLOCK_COLS if -(-d // bn) <= APPLY_MAX_CLUSTER]
    bn = min(fits, key=lambda bn: (-(-d // bn) * bn, -bn)) if fits else APPLY_BLOCK_COLS[-1]
    tiles = -(-d // bn)
    groups = -(-tiles // APPLY_MAX_CLUSTER)
    cluster = -(-tiles // groups)
    m_tiles = -(-m // APPLY_BLOCK_ROWS)
    per_split = m_tiles * groups * cluster
    steps = -(-n // STEP_ROWS)
    want = -(-APPLY_TARGET_BLOCKS // per_split)
    room = max(1, scratch_bytes // (4 * m * d))
    n_splits = max(1, min(want, steps, room, MAX_GRID_Y))
    rows = common.round_up(-(-n // n_splits), STEP_ROWS)
    return ApplyPlan(-(-n // rows), rows, APPLY_BLOCK_ROWS, bn, cluster, groups, m_tiles)


def _splits(family: str, n: int, m: int, d: int, s: int, apply: bool = False) -> int:
    if family == "sjlt":
        return plan_sjlt(n, m, d, s).n_splits
    if apply:
        plan = plan_apply(n, m, d)
        return 0 if plan.direct else plan.n_splits
    return plan_dense_gram(n, m, d).n_splits


def shared_scratch_bytes(family: str, n: int, m: int, d: int, apply: bool = False) -> int:
    """Scratch bytes a call shares among all its workers: the split form of X of
    a dense Gram (:attr:`GramPlan.xs_floats`), else none."""
    return 4 * plan_dense_gram(n, m, d).xs_floats if family in DENSE_GRAMS and not apply else 0


def worker_scratch_bytes(family: str, n: int, m: int, d: int, s: int = 0, apply: bool = False) -> int:
    """Scratch bytes of each worker of a call: its n-split partials (none for a
    dense S·A of one split), and for the SJLT its binned pair list
    (:attr:`SjltPlan.list_ints`)."""
    if family == "sjlt":
        plan = plan_sjlt(n, m, d, s)
        return 4 * (plan.n_splits * m * d + plan.list_ints)
    return 4 * _splits(family, n, m, d, s, apply) * m * d


def worker_chunk(n: int, m: int, d: int, q: int, *, family: str = "gaussian", s: int = 0,
                 apply: bool = False) -> int:
    """Workers per call into the C entry: a q-key Gram of X (n, d) makes
    ``ceil(q / worker_chunk(...))`` calls, each a sketch pass, a split reduction
    and a Gram pass over its chunk of workers. ``family`` (and ``s`` for the
    SJLT) picks the split plan: the dense Grams share one
    (:func:`plan_dense_gram`), the SJLT has its own, and with
    ``apply`` the dense S·A has its own (:func:`plan_apply`; one split keeps no
    partials). The chunk's scratch (:func:`worker_scratch_bytes`) and the
    call's shared scratch (:func:`shared_scratch_bytes`) fit SCRATCH_BYTES, or
    the chunk is one worker. Raises ValueError when the shared scratch alone
    outgrows SCRATCH_BYTES (a dense Gram's split X is up to 128 times X, at
    d′ = 1; at FIG3A it is 1.02 GB)."""
    shared = shared_scratch_bytes(family, n, m, d, apply)
    if shared > SCRATCH_BYTES:
        raise ValueError(f"the {family} Gram's split X of ({n}, {d}) takes {shared} bytes, "
                         f"past the {SCRATCH_BYTES}-byte scratch")
    per_worker = worker_scratch_bytes(family, n, m, d, s, apply and family != "sjlt")
    if per_worker == 0:
        return max(1, min(q, MAX_GRID_Z))
    return max(1, min(q, MAX_GRID_Z, (SCRATCH_BYTES - shared) // per_worker))


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
    plan = plan_dense_gram(n, m, d)
    chunk = worker_chunk(n, m, d, q, family=family)
    kw = _u32_words(keys, X.device)
    G = torch.empty((q, d, d), dtype=torch.float32, device=X.device)
    xs = torch.empty(plan.xs_floats, dtype=torch.float32, device=X.device)
    partial = torch.empty((chunk, plan.n_splits * m * d), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for w0 in range(0, q, chunk):
            qc = min(chunk, q - w0)
            code = lib.repro_dense_gram(  # the first call also writes the split form of X
                FAMILIES[family], X.data_ptr(), n, d, kw[w0].data_ptr(),
                None if srht_rows is None else srht_rows[w0].data_ptr(), qc, m, common.inv_sqrt(m), rounds,
                plan.rows_per_split, plan.n_splits, plan.block_cols, plan.cluster, plan.clusters,
                xs.data_ptr(), plan.x_rows, int(w0 == 0), partial.data_ptr(), G[w0].data_ptr(), stream,
            )
            _check(lib, code, f"{family} sketch_gram launch")
            count_launch(launches, name)
    return G


def gram_clusters(block_cols: int, cluster: int, family: str = "gaussian") -> int:
    """Clusters of ``cluster`` dense Gram blocks of ``family`` and width
    ``block_cols`` the card can hold at once (``cudaOccupancyMaxActiveClusters``;
    0: it cannot launch one)."""
    lib = _library("sketch_gram")
    count = ctypes.c_int(0)
    _check(lib, lib.repro_dense_gram_clusters(FAMILIES[family], block_cols, cluster, ctypes.byref(count)),
           f"{family} dense_gram cluster occupancy")
    return count.value


def _sjlt_call(entry: str, keys: torch.Tensor, X: torch.Tensor, m: int, s: int, out: torch.Tensor, *,
               launches: collections.Counter, name: str, row0: int = 0) -> torch.Tensor:
    """Run ``repro_sjlt_gram`` or ``repro_sjlt_apply`` (with ``row0``, the data
    row X's first row is) over the workers of keys in chunks of
    :func:`worker_chunk`, into ``out`` (its first dim is q)."""
    n, d = X.shape
    q = keys.shape[0]
    plan = plan_sjlt(n, m, d, s)
    lib = _library("sjlt_gram")
    fn = getattr(lib, entry)
    chunk = worker_chunk(n, m, d, q, family="sjlt", s=s)
    kw = _u32_words(keys, X.device)
    # One allocation: the chunk's pair lists (uint32 words), then its partials.
    scratch = torch.empty(chunk * (plan.list_ints + plan.n_splits * m * d), dtype=torch.float32, device=X.device)
    pairs = scratch.data_ptr()
    partial = pairs + 4 * chunk * plan.list_ints
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for w0 in range(0, q, chunk):
            qc = min(chunk, q - w0)
            args = (X.data_ptr(), n, d, kw[w0].data_ptr(), qc, m, s, common.inv_sqrt(s), plan.rows_per_split,
                    plan.n_splits, plan.chunk_rows, plan.bucket_tile, pairs, partial, out[w0].data_ptr())
            code = fn(*args, stream) if entry == "repro_sjlt_gram" else fn(*args, row0, stream)
            _check(lib, code, f"{entry} launch")
            count_launch(launches, name)
    return out


def sjlt_gram(keys: torch.Tensor, X: torch.Tensor, m: int, s: int, *,
              launches: collections.Counter, name: str) -> torch.Tensor:
    """(q, d, d) SJLT Grams ``(S_w X)ᵀ(S_w X)`` of the CUDA tensor X for q key rows,
    s nonzeros per data row: the bin pass, the scatter pass, the split reduction
    and the Gram pass (:func:`plan_sjlt`). Adds one to ``launches[name]`` per call
    into the C entry (one per chunk of workers, see :func:`worker_chunk`)."""
    n, d, q = _check_sketch_args("sjlt_gram", X, keys, m)
    plan_sjlt(n, m, d, s)  # refuses an s or m the kernels cannot take before anything is allocated
    G = torch.empty((q, d, d), dtype=torch.float32, device=X.device)
    return _sjlt_call("repro_sjlt_gram", keys, X, m, s, G, launches=launches, name=name)


def kept_sketch_ld(n: int) -> int:
    """Row stride (floats) of a kept S with n columns: n up to whole 16 bytes."""
    return common.round_up(n, KEPT_ROW_ALIGN)


def keeps_sketch(m: int, n: int) -> bool:
    """Whether a worker's Gaussian S (m, n) is kept from its forward S·A for its
    adjoint (``kept_sketch_ld(n)`` floats a row) rather than drawn again: when it
    fits SCRATCH_BYTES. A function of the shapes only."""
    ld = kept_sketch_ld(n)
    return 4 * m * ld <= SCRATCH_BYTES and m * ld < 2**31


def _check_kept(S: torch.Tensor, device: int, m: int, n: int) -> None:
    """Raise unless S is an (m, ld) kept S on CUDA device ``device`` (an index),
    ld >= n a multiple of KEPT_ROW_ALIGN. The C entries check the rest (16-byte
    alignment; for the store, m·ld < 2**31) and refuse it."""
    if S.get_device() != device or S.dtype != torch.float32 or S.ndim != 2 or not S.is_contiguous():
        raise ValueError(f"a kept S must be a contiguous 2-D float32 tensor on cuda:{device}, got {S.dtype} "
                         f"{tuple(S.shape)} on {S.device}")
    rows, ld = S.shape
    if rows != m or ld < n or ld % KEPT_ROW_ALIGN:
        raise ValueError(f"a kept S of {m} rows and {n} columns must be ({m}, ld), ld >= {n} a multiple of "
                         f"{KEPT_ROW_ALIGN}; got {tuple(S.shape)}")


def _check_row0(row0: int, n: int) -> None:
    if row0 < 0 or row0 + n > 2**32:
        raise ValueError(f"row0 must lie in [0, 2**32 - n] (the counter), got {row0} for n = {n}")


def sketch_apply(family: str, keys: torch.Tensor, X: torch.Tensor, m: int, *, rounds: int,
                 launches: collections.Counter, name: str, s_out: torch.Tensor | None = None,
                 row0: int = 0) -> torch.Tensor:
    """(q, m, d) sketches ``S_w X`` of the CUDA tensor X for q key rows of the
    Gaussian or Rademacher family, on the tensor cores (``csrc/sketch_apply.cu``)
    with the plan of :func:`plan_apply`, so slice w is bitwise a q = 1 call. With
    ``s_out`` (the Gaussian, one key: an (m, ld) float32 tensor on the card, ld
    from :func:`kept_sketch_ld`) the kernel also writes the S it draws there,
    columns ``:n``, and S·X is bitwise the same. ``row0`` (a multiple of 32 for
    the Rademacher, 0 with ``s_out``) is the column of S that X's first row
    meets: the call computes ``S_w[:, row0 : row0 + n] X``, a row tile of a
    taller matrix. Makes no call that waits for the card. Adds one to
    ``launches[name]`` per call into the C entry (one per chunk of workers)."""
    n, d, q = _check_sketch_args("sketch_apply", X, keys, m)
    if family not in ("gaussian", "rademacher"):
        raise ValueError(f"the dense S·A kernel takes the gaussian and rademacher families, got {family!r}")
    _check_row0(row0, n)
    if family == "rademacher" and row0 % STEP_ROWS:
        raise ValueError(f"the Rademacher S·A starts a tile at a whole sign word: row0 % {STEP_ROWS} must be 0, "
                         f"got {row0}")
    if s_out is not None and row0:
        raise ValueError("the dense S·A keeps S for a whole matrix (row0 = 0) only")
    if rounds <= 0 or rounds % 4:
        raise ValueError(f"threefry rounds must be a positive multiple of 4, got {rounds}")
    if s_out is not None:
        if family != "gaussian" or q != 1:
            raise ValueError(f"the dense S·A keeps S for the gaussian family with one key, got {family!r}, q={q}")
        _check_kept(s_out, X.get_device(), m, n)
    lib = _library("sketch_apply")
    plan = plan_apply(n, m, d)
    chunk = worker_chunk(n, m, d, q, apply=True)
    kw = _u32_words(keys, X.device)
    if X.data_ptr() % 16:  # the kernel copies X in 16-byte chunks (a view may start anywhere)
        X = X.clone()
    out = torch.empty((q, m, d), dtype=torch.float32, device=X.device)
    partial = None
    if not plan.direct:
        partial = torch.empty((chunk, plan.n_splits * m * d), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        for w0 in range(0, q, chunk):
            qc = min(chunk, q - w0)
            code = lib.repro_sketch_apply(
                FAMILIES[family], X.data_ptr(), n, d, kw[w0].data_ptr(), qc, m, common.inv_sqrt(m), rounds,
                plan.rows_per_split, plan.n_splits, plan.block_cols, plan.cluster, plan.groups,
                None if partial is None else partial.data_ptr(), out[w0].data_ptr(),
                None if s_out is None else s_out.data_ptr(), 0 if s_out is None else s_out.shape[1], row0, stream,
            )
            _check(lib, code, f"{family} sketch_apply launch")
            count_launch(launches, name)
    return out


def apply_clusters(block_cols: int, cluster: int) -> int:
    """Clusters of ``cluster`` dense S·A blocks of width ``block_cols`` the card
    can hold at once (``cudaOccupancyMaxActiveClusters``; 0: it cannot launch one)."""
    lib = _library("sketch_apply")
    count = ctypes.c_int(0)
    _check(lib, lib.repro_sketch_apply_clusters(block_cols, cluster, ctypes.byref(count)),
           "sketch_apply cluster occupancy")
    return count.value


def sjlt_apply(keys: torch.Tensor, X: torch.Tensor, m: int, s: int, *,
               launches: collections.Counter, name: str, row0: int = 0) -> torch.Tensor:
    """(q, m, d) SJLT sketches ``S_w X`` of the CUDA tensor X for q key rows, s
    nonzeros per data row: the SJLT Gram's bin and scatter passes and split
    reduction on its plan (:func:`plan_sjlt`). ``row0`` is the data row X's first
    row is (its pairs drawn there): the call computes ``S_w[:, row0 : row0 + n] X``.
    Adds one to ``launches[name]`` per call into the C entry (one per chunk of
    workers)."""
    n, d, q = _check_sketch_args("sjlt_apply", X, keys, m)
    _check_row0(row0, n)
    plan_sjlt(n, m, d, s)
    out = torch.empty((q, m, d), dtype=torch.float32, device=X.device)
    return _sjlt_call("repro_sjlt_apply", keys, X, m, s, out, launches=launches, name=name, row0=row0)


@dataclasses.dataclass(frozen=True)
class LongPlan:
    """Row 12b's plan (:func:`plan_sjlt_long`)."""
    pairs: int  # n·s (row, t) pairs
    cols: int  # columns of a group
    bucket_tile: int  # buckets of a partition
    parts: int  # partitions: ceil(m / bucket_tile)
    group_parts: int  # partitions of a first-level group; 0: one level
    sub: int  # second-level count and scatter blocks a group; 0: one level
    chunk_pairs: int  # pairs of a first-level count and scatter block, whole SJLT_LONG_TILE
    chunks: int  # ceil(pairs / chunk_pairs)

    @property
    def groups(self) -> int:
        return -(-self.parts // self.group_parts) if self.group_parts else 0

    @property
    def acc_smem(self) -> int:
        """Shared bytes of an accumulate block: a 64-bit sum and an exponent a
        (bucket, column), a count a bucket."""
        return self.bucket_tile * (12 * self.cols + 4)

    @property
    def pass_width(self) -> int:
        """Partitions (or groups) a count or scatter block counts and places."""
        return max(self.groups, self.group_parts) if self.group_parts else self.parts

    @property
    def scatter_smem(self) -> int:
        """Shared bytes of a scatter block, the larger of the two levels': ten
        words a partition (its place, its first slot in the stage, eight warps'
        counts) and the staged tile (a place, a bucket and cols values an entry;
        SJLT_LONG_LIST_TILE entries over the group list)."""
        per_part, per_entry = 4 * (2 + 8), 4 * (2 + self.cols)
        first = per_part * (self.groups or self.parts) + per_entry * SJLT_LONG_TILE
        return max(first, per_part * self.group_parts + per_entry * SJLT_LONG_LIST_TILE)

    @property
    def scratch_bytes(self) -> int:
        """Device bytes of the C entry's scratch, a mirror of ``long_plan`` in
        ``csrc/sjlt_gram.cu`` (the wrappers ask the C entry itself,
        ``repro_sjlt_long_scratch_bytes``; a ``gpu`` test holds the two equal),
        for planning memory on the host. Each piece to a whole 16 bytes: with
        two levels the groups' (chunks, groups) counts, totals and first entries
        and the group list (a bucket and the values a pair); the partitions'
        counts ((chunks, parts), or (groups·sub, group_parts) with two levels),
        totals and first entries, the entries' buckets (uint16) and values. At
        d′ = 1: 6 B a pair, 14 with two levels; with the pair list and X, 14 and
        22 B a pair of device memory at the call's peak."""
        a16 = lambda b: common.round_up(b, 16)  # noqa: E731
        g, two = self.groups, int(self.groups > 0)
        rows = g * self.sub * self.group_parts if two else self.chunks * self.parts
        return (a16(4 * self.chunks * g) + a16(4 * g) + a16(4 * (g + 1) * two)
                + a16(4 * self.pairs * two) + a16(4 * self.pairs * self.cols * two)
                + a16(4 * rows) + a16(4 * self.parts) + a16(4 * (self.parts + 1))
                + a16(2 * self.pairs) + a16(4 * self.pairs * self.cols))


@functools.lru_cache(maxsize=256)
def plan_sjlt_long(n: int, m: int, d: int, s: int) -> LongPlan:
    """Row 12b's plan for X (n, d) at m sketch rows and s nonzeros a data row, a
    function of the shapes only: partitions of at most as many buckets as an
    accumulate block's shared memory holds for ``min(d, 8)`` columns (its 64-bit
    sums, exponents and counts), as many as fill whole waves of
    SJLT_LONG_TARGET_BLOCKS accumulate blocks (one bucket each where m is
    smaller); chunks of whole SJLT_LONG_TILE pairs; for many partitions and
    pairs, two levels through groups of ceil(sqrt(parts)) partitions, so a
    scatter block writes to about that many segments. No plan changes a result:
    every sum is of exact integers."""
    pairs = n * s
    if not (n > 0 and d > 0 and 0 < m < 2**31 and s > 0 and pairs < 2**32):
        raise ValueError(f"the long-column SJLT S·A takes n, d, s >= 1, 1 <= m < 2**31 and n·s < 2**32 pairs, "
                         f"got n={n} d={d} m={m} s={s}")
    cols = min(d, SJLT_LONG_GROUP_COLS)
    fits = SJLT_LONG_ACC_SMEM // (12 * cols + 4)
    # whole waves of accumulate blocks: a multiple of SJLT_LONG_TARGET_BLOCKS partitions
    want = max(SJLT_LONG_TARGET_BLOCKS, common.round_up(-(-m // fits), SJLT_LONG_TARGET_BLOCKS))
    bucket_tile = -(-m // want)
    parts = -(-m // bucket_tile)
    chunks = max(1, min(SJLT_LONG_CHUNKS, -(-pairs // SJLT_LONG_TILE)))
    chunk_pairs = common.round_up(-(-pairs // chunks), SJLT_LONG_TILE)
    chunks = -(-pairs // chunk_pairs)
    one_level = parts <= SJLT_LONG_ONE_LEVEL_PARTS or (pairs <= SJLT_LONG_ONE_LEVEL_PAIRS
                                                       and parts <= SJLT_LONG_MAX_BINS)
    group_parts = 0 if one_level else math.isqrt(parts - 1) + 1
    sub = 0 if one_level else -(-SJLT_LONG_CHUNKS // -(-parts // group_parts))
    return LongPlan(pairs, cols, bucket_tile, parts, group_parts, sub, chunk_pairs, chunks)


def sjlt_long_scratch_bytes(n: int, m: int, d: int, s: int) -> int:
    """Scratch of one call into ``repro_sjlt_apply_long`` (:attr:`LongPlan.scratch_bytes`),
    reused by each worker in turn; the pair list is beside it."""
    return plan_sjlt_long(n, m, d, s).scratch_bytes


def _long_scratch_bytes(lib, n: int, d: int, m: int, s: int, plan: LongPlan) -> int:
    """The scratch bytes the C entry lays out for ``plan`` (``long_plan``'s own count)."""
    size = lib.repro_sjlt_long_scratch_bytes(n, d, m, s, plan.bucket_tile, plan.group_parts, plan.sub,
                                             plan.chunk_pairs, plan.cols)
    if size < 0:
        raise ValueError(f"repro_sjlt_long_scratch_bytes refused the plan {plan} for n={n} d={d} m={m} s={s}")
    return size


def _host_key_words(keys: torch.Tensor):
    """The (q, 2) key words as a host array of uint32 for the C entry, which
    passes them to its kernels as launch arguments. Keys on the card are
    refused: reading them would wait for the card."""
    if keys.device.type != "cpu":
        raise ValueError(f"row 12b takes its key words from the host; keys are on {keys.device}")
    words = [int(w) & common.MASK32 for w in keys.reshape(-1).tolist()]
    return (ctypes.c_uint32 * len(words))(*words)


def sjlt_apply_long(keys: torch.Tensor, X: torch.Tensor, m: int, s: int, *, launches: collections.Counter,
                    name: str, row0: int = 0, keep_pairs: bool = False):
    """Row 12b: (q, m, d) SJLT sketches ``S_w[:, row0 : row0 + n] X`` of the CUDA
    tensor X for q key rows (on the host), for few, long columns and any
    m < 2**31 (``csrc/sjlt_gram.cu`` ``repro_sjlt_apply_long``: each pair drawn
    once, the pairs partitioned by bucket range, every (bucket, column) summed
    in 64-bit fixed point at its own power of two in shared memory, to L²·2⁻⁶¹
    of its largest term of L, rounded once; plan :func:`plan_sjlt_long`).
    Bitwise the same run to run, and slice w of a q-key call is the call on key
    w. With ``keep_pairs`` (one key) also returns the pair list the kernel drew,
    (n·s,) int32 words ``bucket | sign << 31`` in pair order
    (``operators.sjlt_adjoint_kept`` reads it). Adds one to ``launches[name]``
    per call into the C entry (one for all q workers)."""
    n, d, q = _check_sketch_args("sjlt_apply_long", X, keys, m)
    _check_row0(row0, n)
    if s <= 0 or n * s >= 2**32:
        raise ValueError(f"the long-column SJLT S·A takes s >= 1 and n·s < 2**32 pairs, got n={n} s={s}")
    if keep_pairs and q != 1:
        raise ValueError(f"the pair list is kept for one key, got {q}")
    plan = plan_sjlt_long(n, m, d, s)
    words = _host_key_words(keys)
    lib = _library("sjlt_gram")
    size = _long_scratch_bytes(lib, n, d, m, s, plan)
    # One scratch allocation, the pair list at its end unless it is kept.
    kept = torch.empty(plan.pairs, dtype=torch.int32, device=X.device) if keep_pairs else None
    extra = 0 if keep_pairs else 4 * plan.pairs
    scratch = torch.empty(-(-(size + extra) // 8), dtype=torch.int64, device=X.device)
    pairs = kept.data_ptr() if keep_pairs else scratch.data_ptr() + size
    out = torch.empty((q, m, d), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream(X.device).cuda_stream
        code = lib.repro_sjlt_apply_long(X.data_ptr(), n, d, words, q, m, s, common.inv_sqrt(s), row0,
                                         plan.bucket_tile, plan.group_parts, plan.sub, plan.chunk_pairs, plan.cols,
                                         pairs, scratch.data_ptr(), size, out.data_ptr(), stream)
        _check(lib, code, "repro_sjlt_apply_long launch")
        count_launch(launches, name)
    return (out, kept) if keep_pairs else out


def sjlt_long_partition(key: torch.Tensor, X: torch.Tensor, m: int, s: int, *, row0: int = 0) -> dict:
    """Row 12b's count, scan and scatter passes alone (``repro_sjlt_long_partition``)
    for one host key and its first column group: the pair list (int32), each
    partition's first entry (``base``, parts + 1, int32) and
    the entries' buckets within their partitions (int16 bits of uint16) and
    values, on the card, for checking them against ``sjlt.ref.long_partition``."""
    n, d = X.shape
    _check_sketch_args("sjlt_long_partition", X, key.reshape(1, 2), m)
    plan = plan_sjlt_long(n, m, d, s)
    lib = _library("sjlt_gram")
    dev = X.device
    got = {"pairs": torch.empty(plan.pairs, dtype=torch.int32, device=dev),
           "base": torch.empty(plan.parts + 1, dtype=torch.int32, device=dev),
           "ebucket": torch.empty(plan.pairs, dtype=torch.int16, device=dev),
           "evals": torch.empty((plan.pairs, plan.cols), dtype=torch.float32, device=dev)}
    size = _long_scratch_bytes(lib, n, d, m, s, plan)
    scratch = torch.empty(-(-size // 8), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        code = lib.repro_sjlt_long_partition(
            X.data_ptr(), n, d, _host_key_words(key), m, s, row0, plan.bucket_tile, plan.group_parts, plan.sub,
            plan.chunk_pairs, plan.cols, got["pairs"].data_ptr(), got["base"].data_ptr(),
            got["ebucket"].data_ptr(), got["evals"].data_ptr(), scratch.data_ptr(), size,
            torch.cuda.current_stream(dev).cuda_stream)
    _check(lib, code, "repro_sjlt_long_partition launch")
    return got


def sjlt_bins(keys: torch.Tensor, n: int, m: int, d: int, s: int) -> torch.Tensor:
    """The SJLT bin pass alone: each worker's binned pair list, (q, chunks,
    region_ints) int32 on the card, as the scatter pass of X (n, d) reads it
    (:attr:`SjltPlan.region_ints`; words past a chunk's bin offsets and entries
    are not written). For checking it against ``sjlt.ref.bin_pairs``."""
    plan = plan_sjlt(n, m, d, s)
    lib = _library("sjlt_gram")
    dev = torch.device("cuda")
    kw = _u32_words(keys, dev)
    out = torch.zeros((keys.shape[0], plan.chunks, plan.region_ints), dtype=torch.int32, device=dev)
    code = lib.repro_sjlt_bins(n, d, kw.data_ptr(), keys.shape[0], m, s, plan.rows_per_split, plan.n_splits,
                               plan.chunk_rows, plan.bucket_tile, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check(lib, code, "repro_sjlt_bins launch")
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


@functools.lru_cache(maxsize=64)
def _packed_fwht_plan(n: int) -> tuple[int, int]:
    """(the stage counts of :func:`plan_fwht` packed 4 bits a pass, pass p in
    bits 4p..4p+3; the passes): the plan as the C entries take it."""
    plan = plan_fwht(n)
    return sum(t << (4 * p) for p, t in enumerate(plan)), len(plan)


def _check_2d_float32(name: str, x: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(
            f"{name} must be a contiguous 2-D float32 tensor, got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}"
        )


def fwht(x: torch.Tensor, *, launches: collections.Counter, name: str) -> torch.Tensor:
    """H·x for the CUDA tensor x (n, k) float32, contiguous, n a power of two, in
    the passes of :func:`plan_fwht` (the first reads x, the rest work in place
    on the result). One allocation (the output); the C entry makes x's device
    current for the launches. Adds one to ``launches[name]`` per call into it."""
    if not x.is_cuda:
        raise ValueError(f"fwht launches a CUDA kernel; x is on {x.device}")
    _check_2d_float32("x", x)
    n, k = x.shape
    if not (0 < k < 2**31 and n * k < 2**62):
        raise ValueError(f"unsupported shape n={n} k={k}")
    packed, passes = _packed_fwht_plan(n)
    lib = _LIBS.get("fwht") or _library("fwht")
    y = torch.empty_like(x)
    dev = x.get_device()
    code = lib.repro_fwht(x.data_ptr(), y.data_ptr(), n, k, packed, passes, dev,
                          torch._C._cuda_getCurrentRawStream(dev))
    if code:
        _check(lib, code, "fwht launch")
    count_launch(launches, name)
    return y


def srht_forward(kd0: int, kd1: int, rows: torch.Tensor, A: torch.Tensor, n_pad: int, *,
                 launches: collections.Counter, name: str) -> torch.Tensor:
    """The SRHT's S·A (m, k) = (H·pad(D·A, n_pad))[rows] · inv_sqrt(m) for the CUDA
    tensor A (n, k) float32, contiguous, n <= n_pad (a power of two, at most
    2**31), D the Rademacher diagonal of key words (kd0, kd1) and ``rows`` the m
    sampled Hadamard row ids, a 1-D integer tensor on the CPU (as ``SRHTOp``
    keeps them), each in [0, n_pad). One call into ``csrc/fwht.cu``
    ``repro_srht_forward``: D at the first pass's loads, only the sampled rows
    written by the last, on the passes of :func:`plan_fwht` (a scratch between
    them); each last-pass block scans the ids on the card for its group.
    Allocations: the output, the scratch (two or more passes) and the ids on the
    card, copied as int32 through a pinned buffer, so no call waits for the
    card. Adds one to ``launches[name]``."""
    if not A.is_cuda:
        raise ValueError(f"srht_forward launches a CUDA kernel; A is on {A.device}")
    _check_2d_float32("A", A)
    if rows.device.type != "cpu" or rows.ndim != 1 or rows.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"rows must be a 1-D int32 or int64 tensor on the CPU, got {rows.dtype} "
                         f"{tuple(rows.shape)} on {rows.device}")
    n, k = A.shape
    m = rows.shape[0]
    packed, passes = _packed_fwht_plan(n_pad)
    if not (0 < n <= n_pad <= 2**31 and 0 < k < 2**31 and 0 < m < 2**31
            and n_pad * common.round_up(k, FWHT_SCRATCH_ALIGN) < 2**62):
        raise ValueError(f"unsupported shape n={n} k={k} m={m} n_pad={n_pad}")
    ids = rows.numpy()
    if ids.view(np.uint64 if ids.itemsize == 8 else np.uint32).max() >= n_pad:  # a negative id wraps past n_pad
        raise ValueError(f"sampled row ids must lie in [0, n_pad = {n_pad})")
    staged = torch.empty(m, dtype=torch.int32, pin_memory=True)
    staged.numpy()[:] = ids
    ids_dev = staged.to(A.device, non_blocking=True)
    out = A.new_empty((m, k))
    ld = common.round_up(k, FWHT_SCRATCH_ALIGN)
    scratch = None
    if passes > 1:  # the rows every pass but the last can make nonzero
        lo = n_pad.bit_length() - 1 - plan_fwht(n_pad)[-1]
        scratch = A.new_empty((common.round_up(n, 1 << lo), ld))
    dev = A.get_device()
    lib = _LIBS.get("fwht") or _library("fwht")
    code = lib.repro_srht_forward(A.data_ptr(), n, k, kd0, kd1, ids_dev.data_ptr(), m, common.inv_sqrt(m),
                                  out.data_ptr(), None if scratch is None else scratch.data_ptr(), ld, n_pad,
                                  packed, passes, dev, torch._C._cuda_getCurrentRawStream(dev))
    if code:
        _check(lib, code, "srht_forward launch")
    count_launch(launches, name)
    return out


@functools.lru_cache(maxsize=256)
def plan_adjoint(m: int, n: int, k: int) -> tuple[int, int]:
    """``(n_splits, rows_per_split)`` of the m sketch rows for both Gaussian
    adjoints of Y (m, k) into (n, k): about ADJOINT_TARGET_WARPS strips of
    ADJOINT_ROWS output rows times splits (whole blocks of
    ADJOINT_SPLITS_PER_BLOCK where there are that many; at the Fig. 4(b) shape
    16 splits, the fastest measured, ``tools/adjoint_tune.py``), at most
    ADJOINT_MAX_SPLITS, at least ADJOINT_MIN_SPLIT_ROWS rows a split (unless m
    is smaller), no split empty. A function of the shapes only, so reruns add
    the same partials in the same order, and the two kernels, whose chains and
    split order agree, are bitwise equal on one key."""
    want = max(1, ADJOINT_TARGET_WARPS // -(-n // ADJOINT_ROWS))
    if want >= ADJOINT_SPLITS_PER_BLOCK:
        want -= want % ADJOINT_SPLITS_PER_BLOCK
    most = max(1, m // ADJOINT_MIN_SPLIT_ROWS)
    rows = -(-m // min(want, most, ADJOINT_MAX_SPLITS))
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
    count_launch(launches, name)
    return out


def gaussian_adjoint_kept(S: torch.Tensor, Y: torch.Tensor, n: int, *, launches: collections.Counter,
                          name: str) -> torch.Tensor:
    """Sᵀ·Y (n, k) for the CUDA tensors Y (m, k) float32, contiguous, and S, the
    (m, ld) Gaussian sketch a forward :func:`sketch_apply` kept (``s_out``; its
    columns ``:n``), read once (``csrc/adjoint.cu`` ``repro_adjoint_kept``, plan
    :func:`plan_adjoint`: bitwise :func:`gaussian_adjoint` on the same key). One
    launch, one allocation (the output), no key words, no call that waits for
    the card; the C entry makes Y's device current for the launch. Adds one to
    ``launches[name]``."""
    if not Y.is_cuda:
        raise ValueError(f"gaussian_adjoint_kept launches a CUDA kernel; Y is on {Y.device}")
    if Y.dtype != torch.float32 or Y.ndim != 2 or not Y.is_contiguous():
        raise ValueError(
            f"Y must be a contiguous 2-D float32 tensor, got {Y.dtype} {tuple(Y.shape)} "
            f"contiguous={Y.is_contiguous()}"
        )
    m, k = Y.shape
    if not (0 < k <= MAX_GRID_Y * ADJOINT_KEPT_COLS and 0 < n < 2**31):
        raise ValueError(f"unsupported shape m={m} k={k} n={n}")
    dev = Y.get_device()
    _check_kept(S, dev, m, n)
    n_splits, rows = plan_adjoint(m, n, k)
    lib = _LIBS.get("adjoint") or _library("adjoint")
    out = Y.new_empty((n, k))
    # The raw handle of the device's current stream (torch's own kernel launchers
    # read it so; ``torch.cuda.current_stream`` builds a Stream object a call).
    code = lib.repro_adjoint_kept(S.data_ptr(), S.stride(0), Y.data_ptr(), m, k, n, rows, n_splits, out.data_ptr(),
                                  dev, torch._C._cuda_getCurrentRawStream(dev))
    if code:
        _check(lib, code, "gaussian_adjoint_kept launch")
    count_launch(launches, name)
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


def mma_rate(blocks: int, iters: int) -> tuple[Callable[[], None], float]:
    """``(run, flops)``: ``run()`` launches ``csrc/mma_probe.cu``'s register-only
    ``mma.sync`` TF32 loop on ``blocks`` blocks of 8 warps, ``iters`` rounds of 8
    products a warp, ``flops`` operations in all; the caller times it."""
    lib = _library("mma_probe")
    out = torch.empty(blocks * 256, device="cuda")

    def run() -> None:
        _check(lib, lib.repro_mma_rate(blocks, iters, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
               "mma_rate launch")

    return run, float(blocks * 8 * 8 * iters * 2048)


def mma_probe(A: torch.Tensor, B: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One warp's ``A @ B`` on the tensor cores, A (16, 8) and B (8, 8) float32 on
    the card: (one TF32 product, the 3xTF32 form the dense S·A uses), for checking
    the fragment layouts of ``csrc/tf32.cuh`` against a float64 product."""
    if A.shape != (16, 8) or B.shape != (8, 8) or A.device.type != "cuda":
        raise ValueError(f"mma_probe takes A (16, 8) and B (8, 8) on the card, got {A.shape}, {B.shape}")
    lib = _library("mma_probe")
    A, B = A.float().contiguous(), B.to(A.device).float().contiguous()
    d1, d3 = torch.empty((16, 8), device=A.device), torch.empty((16, 8), device=A.device)
    with torch.cuda.device(A.device):
        code = lib.repro_mma_probe(A.data_ptr(), B.data_ptr(), d1.data_ptr(), d3.data_ptr(),
                                   torch.cuda.current_stream(A.device).cuda_stream)
    _check(lib, code, "mma_probe launch")
    return d1, d3
