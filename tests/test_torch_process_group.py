"""Algorithm 1 and gradient compression across processes (``torch.distributed``).

* ``gloo`` groups of 2 and 4 CPU ranks (spawned once per size, ``file://``
  rendezvous under ``tmp_path``; ranks in ``tests/_torch_group_worker.py``):
  ``psum_average`` with a straggler mask and with an empty round under both
  ``on_empty``; the worker, master (fused and qr), least-norm, multi-round and
  row-sharded x̄ through the group against the same path on one process without
  one, within 1e-6 (relative, ∞-norm: the ranks' partial sums add in another
  order); every rank's x̄ the same; the compressed gradient means; a group of one
  rank bitwise the one-process x̄.
* The reference on a real 4-device ``jax.sharding.Mesh`` (a subprocess that sets
  the host device count before importing jax): its ``compressed_psum_mean`` and
  ``masked_compressed_mean`` under ``shard_map`` against the port's over 4 gloo
  ranks on the same per-rank gradients (1e-6 of the leaf's largest entry), and
  its ``row_sharded`` x̄ beside the port's. The reference pairs worker w's block
  of A with the first block of b (its b is replicated: x̄ equals the composition
  on ``b[:n/q]``); the port pairs it with its own ``b_w``, as the
  reference's docstring says. Both facts are held here side by side.
* In this process, by kind: the port's ``row_sharded`` x̄ against the
  reference's workers composed on each worker's own ``(A_w, b_w)`` (1e-4, the
  tolerance of ``test_torch_distributed.py``: d×d solves amplify the Grams'
  float32 differences).

Each spawn is joined with its own timeout, so a hung rank fails its tests and
does not hold the suite.
"""
import os
import subprocess
import sys
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_group_worker as gw
from repro.core import sketches as jsk, solve as jsolve
from repro.utils import prng as jprng
from repro_torch.core import averaging as tavg, distributed as tdist, sketches as tsk
from repro_torch.launch import mesh as tmesh
from repro_torch.utils import prng as tprng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPAWN_TIMEOUT_S = 120
GROUP_TOL = 1e-6
KINDS = ["gaussian", "rademacher", "srht", "sjlt", "uniform"]


def _spawn(world: int, tmp_path) -> list:
    """Run ``gw.run_rank`` on ``world`` spawned ranks; their saved results by rank."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(gw.run_rank, args=(world, str(tmp_path / "rendezvous"), str(tmp_path)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} gloo ranks did not finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    assert not any(p.is_alive() for p in ctx.processes)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """``get(world)``: the ranks' results of one spawn of ``world`` gloo ranks,
    spawned at first use and shared by every test of this module."""
    runs = {}

    def get(world: int) -> list:
        if world not in runs:
            runs[world] = _spawn(world, tmp_path_factory.mktemp(f"gloo{world}"))
        return runs[world]

    return get


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def ranks(request, group_runs):
    return request.param, group_runs(request.param)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_worker_index_is_the_rank(ranks):
    world, res = ranks
    assert [int(r["worker_index"]) for r in res] == list(range(world))
    assert tavg.worker_index(None) == 0


def test_psum_average_with_stragglers_and_empty_rounds(ranks):
    _, res = ranks
    xs = gw.worker_outputs().astype(np.float64)
    want = (xs * gw.MASK[:, None]).sum(0) / gw.MASK.sum()
    for r in res:
        assert _rel(r["psum_masked"], want) <= GROUP_TOL
        assert np.isnan(r["psum_empty_nan"]).all()
        assert np.array_equal(r["psum_empty_zero"], np.zeros(gw.D, np.float32))
        assert np.array_equal(r["psum_masked"], res[0]["psum_masked"])


def test_psum_average_without_a_group_is_masked_average():
    xs = torch.from_numpy(gw.worker_outputs())
    mask = torch.from_numpy(gw.MASK)
    assert torch.equal(tavg.psum_average(xs, mask), tavg.masked_average(xs, mask))
    for on_empty in ("nan", "zero"):
        empty = torch.from_numpy(gw.EMPTY)
        assert torch.equal(tavg.psum_average(xs, empty, on_empty=on_empty).nan_to_num(7.0),
                           tavg.masked_average(xs, empty, on_empty=on_empty).nan_to_num(7.0))


@pytest.mark.parametrize("path", gw.PATHS)
def test_group_xbar_matches_one_process(ranks, path):
    """Through the group every rank returns one x̄, within 1e-6 of the path on one
    process without a group (row-sharded: one process given all n rows)."""
    _, res = ranks
    want = res[0][f"none_all_{path}"]
    assert np.isfinite(want).all()
    for r in res:
        assert _rel(r[f"group_{path}"], want) <= GROUP_TOL
        assert np.array_equal(r[f"group_{path}"], res[0][f"group_{path}"])


@pytest.mark.parametrize("path", ["worker", "master", "least_norm"])
def test_group_of_one_rank_is_bitwise_no_group(ranks, path):
    _, res = ranks
    for r in res:
        assert np.array_equal(r[f"one_{path}"], r[f"none_{path}"])


@pytest.mark.parametrize("name", list(gw.COMP_CFGS))
def test_compressed_psum_mean_is_the_mean_of_the_ranks(ranks, name):
    """Against the port's one-process composition: the mean of the ranks' leaves
    (off), the unsketched mean payload (same_sketch), the mean of the ranks'
    reconstructions with S folded by rank (fresh_sketch)."""
    from repro_torch.core import gradcomp

    world, res = ranks
    cfg = gradcomp.GradCompressionConfig(**gw.COMP_CFGS[name])
    key = tprng.prng_key(gw.SEED)
    g = [{k: torch.from_numpy(v) for k, v in gw.grads(r).items()} for r in range(world)]
    if not cfg.enabled:
        want = {k: sum(x[k] for x in g) / world for k in gw.GRAD_SHAPES}
    elif cfg.mode == "same_sketch":
        payloads = [gradcomp.compress(cfg, key, x) for x in g]
        want = gradcomp.decompress(cfg, sum(p for p, _ in payloads) / world, payloads[0][1])
    else:
        recs = [gradcomp.decompress(cfg, *gradcomp.compress(cfg, tprng.fold_in(key, r), x)) for r, x in enumerate(g)]
        want = {k: sum(x[k] for x in recs) / world for k in gw.GRAD_SHAPES}
    for r in res:
        for leaf in gw.GRAD_SHAPES:
            assert _rel(r[f"comp_{name}_{leaf}"], want[leaf].numpy()) <= GROUP_TOL


def test_init_worker_group_refuses_what_it_cannot_serve(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="rank and world size"):
        tmesh.init_worker_group(device="cpu")
    with pytest.raises(ValueError, match="nccl"):
        tmesh.init_worker_group("nccl", device="cpu", rank=0, world_size=1)
    with pytest.raises(ValueError, match="outside"):
        tmesh.init_worker_group(device="cpu", rank=2, world_size=2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.init_worker_group(rank=0, world_size=1)  # never the CPU on its own


def test_group_entry_points_refuse_q_that_does_not_split(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 3)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    A, b, _, _ = (torch.from_numpy(a) for a in gw.problem())
    with pytest.raises(ValueError, match="split evenly"):
        tdist.distributed_sketch_solve(tsk.SketchSpec("gaussian", gw.M), tprng.prng_key(0), A, b, q=gw.Q,
                                       device="cpu", group=object())


def test_row_sharded_refuses_rows_the_workers_do_not_divide():
    A, b, _, _ = (torch.from_numpy(a) for a in gw.problem())
    with pytest.raises(ValueError, match="q must divide n"):
        tdist.distributed_sketch_solve(tsk.SketchSpec("gaussian", gw.M), tprng.prng_key(0), A[:511], b[:511],
                                       q=gw.Q, device="cpu", row_sharded=True)


# --------------------------------------------- row-sharded workers against the reference


def _spec(sk, kind):
    return sk.SketchSpec(kind, gw.M, s=gw.SJLT_S)


@pytest.mark.parametrize("kind", KINDS)
def test_row_sharded_is_the_reference_workers_on_their_own_rows(kind):
    A, b, _, _ = gw.problem()
    jkey = jax.random.PRNGKey(gw.SEED)
    blk = gw.N // gw.Q
    want = np.mean([np.asarray(jsolve.sketch_and_solve(_spec(jsk, kind), jprng.worker_key(jkey, w, 0),
                                                       jnp.asarray(A[w * blk : (w + 1) * blk]),
                                                       jnp.asarray(b[w * blk : (w + 1) * blk])))
                    for w in range(gw.Q)], axis=0)
    got = tdist.distributed_sketch_solve(_spec(tsk, kind), tprng.prng_key(gw.SEED), torch.from_numpy(A),
                                         torch.from_numpy(b), q=gw.Q, device="cpu", row_sharded=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4 * np.abs(want).max())


# ------------------------------------------------ the reference on a 4-device jax mesh

_REFERENCE_MESH = """
import json, os, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
sys.path.insert(0, {tests!r})
import _torch_group_worker as gw
from repro.core import distributed, gradcomp, sketches as sk, solve
from repro.train import sketch_dp
from repro.utils import prng
from repro.utils.compat import shard_map

mesh = Mesh(np.array(jax.devices()), ("data",))
assert mesh.shape["data"] == 4
key = jax.random.PRNGKey(gw.SEED)
A, b, _, _ = gw.problem()
spec = sk.SketchSpec("uniform", gw.M)
out = {{}}
# jit around shard_map compiles the mesh program once (eager shard_map runs op by op).
out["row_sharded"] = jax.jit(lambda A, b: distributed.distributed_sketch_solve(
    mesh, spec, key, A, b, row_sharded=True))(jnp.asarray(A), jnp.asarray(b))
q = 4  # one worker a mesh device
blk = gw.N // q
for name, rows_b in (("first_b", lambda w: slice(0, blk)), ("own_b", lambda w: slice(w * blk, (w + 1) * blk))):
    out["compose_" + name] = np.mean([np.asarray(solve.sketch_and_solve(
        spec, prng.worker_key(key, w, 0), jnp.asarray(A[w * blk:(w + 1) * blk]), jnp.asarray(b[rows_b(w)])))
        for w in range(q)], axis=0)
g = {{k: jnp.stack([jnp.asarray(gw.grads(r)[k]) for r in range(4)]) for k in gw.GRAD_SHAPES}}
mask = jnp.asarray(gw.RANK_MASK[4], jnp.float32)
local = lambda t: jax.tree_util.tree_map(lambda x: x[0], t)
for name, kw in gw.COMP_CFGS.items():
    cfg = gradcomp.GradCompressionConfig(**kw)
    fn = jax.jit(shard_map(lambda g, cfg=cfg: gradcomp.compressed_psum_mean(cfg, key, local(g), ("data",)),
                           mesh=mesh, in_specs=(P("data"),), out_specs=P()))
    for leaf, v in fn(g).items():
        out[f"comp_{{name}}_{{leaf}}"] = v
for name, kw in gw.MASKED_CFGS.items():
    cfg = gradcomp.GradCompressionConfig(**kw)
    fn = jax.jit(shard_map(lambda g, mk, cfg=cfg: sketch_dp.masked_compressed_mean(cfg, key, local(g), mk[0], ("data",)),
                           mesh=mesh, in_specs=(P("data"), P("data")), out_specs=P()))
    for leaf, v in fn(g, mask).items():
        out[f"masked_{{name}}_{{leaf}}"] = v
np.savez({dest!r}, **{{k: np.asarray(v) for k, v in out.items()}})
"""


@pytest.fixture(scope="module")
def reference_mesh(tmp_path_factory):
    """The reference's row-sharded x̄, its compositions and its compressed means,
    computed on a 4-device ``jax.sharding.Mesh`` in a fresh interpreter."""
    dest = tmp_path_factory.mktemp("jaxmesh") / "reference.npz"
    script = _REFERENCE_MESH.format(tests=os.path.join(ROOT, "tests"), dest=str(dest))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=600, env=env)
    assert out.returncode == 0, f"STDOUT:\n{out.stdout}\nSTDERR:\n{out.stderr}"
    return dict(np.load(dest))


@pytest.mark.subprocess
def test_reference_row_sharded_pairs_blocks_with_the_first_b_and_the_port_with_its_own(reference_mesh):
    """Both packages' row-sharded x̄ side by side, q = 4 (one worker a device):
    the reference's is its workers on (A_w, b[:n/q]) (to float32 rounding: the
    mesh program is compiled, the composition runs op by op); the port's is the
    workers on (A_w, b_w)."""
    ref = reference_mesh
    assert _rel(ref["row_sharded"], ref["compose_first_b"]) <= 1e-5
    A, b, _, _ = gw.problem()
    port = tdist.distributed_sketch_solve(tsk.SketchSpec("uniform", gw.M), tprng.prng_key(gw.SEED),
                                          torch.from_numpy(A), torch.from_numpy(b), q=4, device="cpu",
                                          row_sharded=True).numpy()
    assert _rel(port, ref["compose_own_b"]) <= 1e-4
    gap = _rel(ref["compose_first_b"], ref["compose_own_b"])
    assert gap > 1e-2 and _rel(port, ref["row_sharded"]) > 1e-2, gap


@pytest.mark.subprocess
@pytest.mark.parametrize("name", [f"comp_{c}" for c in gw.COMP_CFGS] + [f"masked_{c}" for c in gw.MASKED_CFGS])
def test_compressed_means_match_the_reference_under_shard_map(reference_mesh, group_runs, name):
    """The port's means over 4 gloo ranks against the reference's over 4 mesh
    devices, on the same per-rank gradients, key and rank masks."""
    for r in group_runs(4):
        for leaf in gw.GRAD_SHAPES:
            want = reference_mesh[f"{name}_{leaf}"]
            assert r[f"{name}_{leaf}"].dtype == want.dtype
            assert _rel(r[f"{name}_{leaf}"], want) <= GROUP_TOL, leaf
