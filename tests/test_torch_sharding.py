"""The reference's sharding rules as DTensor placements, the meshes, a sharded
loss on a gloo mesh and ``elastic_restore`` (``repro_torch.distributed``).

* Specs against the reference's, entry for entry, on both production rule
  sets (one pod; two pods with ``POD_FSDP_ARCHS``' fsdp over ("pod", "data")):
  every parameter leaf of every config of ``PORTED`` (the reference's
  ``param_pspecs`` over ``lm.param_shapes``, a mesh-free oracle), the train
  state's, the cache's for both ``batch_sharded`` and the inputs' for every
  shape of ``SHAPES``; a port layer's tensor takes its stacked leaf's spec
  without the leading L entry.
* Placements and local slices on a fake mesh of 512 ranks (this process rank
  0; the group is destroyed after the module), held against DTensor's own
  ``compute_local_shape_and_global_offset`` at every coordinate of a
  (2, 2) mesh and at sampled ones of the (2, 16, 16) mesh; ``constrain``; the
  production and smoke meshes and their refusals.
* On 4 spawned CPU ranks in a gloo group, the (2, 2) mesh: the reference's
  checkpoints (a bf16 train state with random moments, float32 parameters,
  and leaves no axis divides) restored by ``elastic_restore``, each rank's
  local shard bitwise the matching slice of the reference's array and the
  gathered tensor bitwise the array; the narrow 2-layer model's loss on
  DTensors under the production rules within ``LOSS_TOL`` of one process's
  (the sharded products and reductions add in other orders); one sharded
  train step (``make_train_step`` with ``rules``) from the reference's float32
  train state restored onto the mesh: every gradient AdamW receives placed as
  its parameter, the moments' placements kept, and the gathered parameters,
  moments, count, loss and gradient norm within ``STEP_TOL`` of one
  process's step from the same checkpoint; and for every config of
  ``PORTED`` reduced, the sharded loss and gradients (each placed as its
  parameter) within ``LOSS_TOL`` and ``GRAD_TOL`` of one process's.
"""
import dataclasses
import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import _torch_sharding_worker as sw
from repro.checkpoint import store as jck
from repro.configs import get_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.data import specs as jspecs
from repro.distributed import sharding as jsh
from repro.launch import dryrun as jdry
from repro.launch import mesh as jmesh
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamW
from repro.train import state as jstate
from repro_torch.configs import PORTED, SHAPES, get_config
from repro_torch.data import specs as tspecs
from repro_torch.distributed import sharding as tsh
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig
from repro_torch.train import state as tstate
from repro_torch.utils import compat
from repro_torch.utils import tree as tu

torch.set_num_threads(1)

SPAWN_TIMEOUT_S = 180
LOSS_TOL = 1e-5  # |sharded − one process| / |one process|, float32
# One AdamW step, float32: |sharded − one process| ≤ STEP_TOL · (1 + |one process|), elementwise.
STEP_TOL = 1e-6
# A reduced config's gradient, float32: max |sharded − one process| ≤ GRAD_TOL · max |one process|, per parameter.
GRAD_TOL = 1e-5


def _rules(arch: str, multi_pod: bool):
    """(reference rules, port rules) of the production mesh."""
    jr, tr = jmesh.production_rules(multi_pod=multi_pod), tmesh.production_rules(multi_pod=multi_pod)
    if multi_pod and arch in jdry.POD_FSDP_ARCHS:
        jr, tr = dataclasses.replace(jr, fsdp=("pod", "data")), dataclasses.replace(tr, fsdp=("pod", "data"))
    return jr, tr


def _jspec(p) -> tuple:
    return tuple(p)


def _jflat(tree) -> dict:
    """The reference's spec tree by path string."""
    leaves = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): _jspec(s) for path, s in leaves}


RULE_SETS = [pytest.param(a, m, id=f"{a}-{'multi' if m else 'single'}") for a in PORTED for m in (False, True)]


@pytest.fixture(scope="module")
def reference_param_specs():
    """The reference's ``param_pspecs`` over ``lm.param_shapes`` by (arch, multi_pod)."""
    out = {}
    for arch in PORTED:
        shapes = jlm.param_shapes(jget(arch))
        for multi in (False, True):
            out[arch, multi] = _jflat(jsh.param_pspecs(shapes, _rules(arch, multi)[0]))
    return out


@pytest.mark.parametrize("arch,multi", RULE_SETS)
def test_param_specs_match_the_reference(arch, multi, reference_param_specs):
    want = reference_param_specs[arch, multi]
    named = dict(tlm.meta_params(get_config(arch)).named_parameters())
    got = tsh.spec_leaves(tsh.param_pspecs(tu.stacked_tree(named), _rules(arch, multi)[1]))
    assert got == want
    # each layer's tensor: the stacked spec without its L entry
    per = tsh.named_pspecs(named, _rules(arch, multi)[1])
    for name, spec in per.items():
        path, layer = tsh._ref_path(name)
        assert spec == (want[path][1:] if layer else want[path]), name


@pytest.mark.parametrize("arch,multi", RULE_SETS)
def test_train_state_specs_match_the_reference(arch, multi):
    cfg = jget(arch).reduced()
    jr, tr = _rules(arch, multi)
    want = _jflat(jstate.train_state_pspecs(cfg, JAdamW(), jr))
    got = tsh.spec_leaves(tstate.train_state_pspecs(get_config(arch).reduced(), AdamWConfig(), tr))
    assert got == want


@pytest.mark.parametrize("batch_sharded", [True, False], ids=["batch_sharded", "seq_all"])
@pytest.mark.parametrize("arch,multi", RULE_SETS)
def test_cache_specs_match_the_reference(arch, multi, batch_sharded):
    jr, tr = _rules(arch, multi)
    want = _jflat(jsh.cache_pspecs(jlm.cache_shapes(jget(arch), 4, 64), jr, batch_sharded=batch_sharded))
    cache = tlm.cache_shapes(get_config(arch), 4, 64)
    got = tsh.spec_leaves(tsh.cache_pspecs(cache, tr, batch_sharded=batch_sharded))
    assert got == want
    ref = {k: tuple(v.shape) for k, v in _jshapes(jlm.cache_shapes(jget(arch), 4, 64)).items()}
    assert {k: tuple(v.shape) for k, v in _tflat(cache).items()} == ref


def _jshapes(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): x for path, x in leaves}


def _tflat(tree, prefix="") -> dict:
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_tflat(tree[k], f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch,multi", RULE_SETS)
def test_input_specs_and_batch_specs_match_the_reference(arch, multi, shape):
    jcfg, tcfg = jget(arch), get_config(arch)
    jr, tr = _rules(arch, multi)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jspecs.input_specs(jcfg, JSHAPES[shape]).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in tspecs.input_specs(tcfg, SHAPES[shape]).items()}
    assert got == want
    assert all(v.device.type == "meta" for v in tspecs.input_specs(tcfg, SHAPES[shape]).values())
    assert tspecs.batch_pspecs(tcfg, SHAPES[shape], tr) == {k: _jspec(v) for k, v in
                                                           jspecs.batch_pspecs(jcfg, JSHAPES[shape], jr).items()}


def test_rules_resolve_as_the_reference():
    for jr, tr in ((jsh.DEFAULT_RULES, tsh.DEFAULT_RULES), (jsh.REPLICATED_RULES, tsh.REPLICATED_RULES),
                   _rules("grok-1-314b", True), _rules("granite-3-8b", True)):
        for a in ("dp", "fsdp", "tensor", "sp", None):
            assert tr.resolve(a) == jr.resolve(a)
        assert tr.spec("dp", "sp", None, "tensor") == _jspec(jr.spec("dp", "sp", None, "tensor"))


# ------------------------------------------------------------------ on a fake mesh


@pytest.fixture(scope="module")
def fake512():
    """This process as rank 0 of a fake group of 512 ranks, destroyed after the module."""
    import torch.distributed as dist

    tdry.start_fake_group(512)
    yield
    dist.destroy_process_group()


def test_production_and_smoke_meshes(fake512):
    multi = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    assert tuple(multi.shape) == (2, 16, 16) and multi.mesh_dim_names == ("pod", "data", "model")
    assert [compat.axis_size(multi, a) for a in ("pod", "data", "model")] == [2, 16, 16]
    with pytest.raises(KeyError):
        compat.axis_size(multi, "expert")
    with pytest.raises(RuntimeError):  # the group has 512 ranks, a pod 256
        tmesh.make_production_mesh(device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tmesh.make_production_mesh(multi_pod=True)  # the default is the card
    smoke = tmesh.make_smoke_mesh(device_type="cpu")
    assert tuple(smoke.shape) == (128, 4) and smoke.mesh_dim_names == ("data", "model")
    for n, want in ((512, (128, 4)), (6, (3, 2)), (3, (3, 1)), (1, (1, 1))):
        # the reference's choice of the model axis, from jax's own function's rule
        model = next(c for c in (4, 2, 1) if n % c == 0 and c <= n)
        assert (n // model, model) == want


def test_meshes_need_a_group():
    """In a fresh process (no group up): both meshes refuse."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        from repro_torch.launch import mesh
        for make in (lambda: mesh.make_production_mesh(device_type="cpu"),
                     lambda: mesh.make_smoke_mesh(device_type="cpu"),
                     lambda: mesh.make_production_mesh()):
            try:
                make()
            except RuntimeError:
                continue
            raise SystemExit("a mesh was made without a group")
        print("refused")
    """)
    env = dict(os.environ, PYTHONPATH=os.path.join(os.path.dirname(os.path.dirname(__file__)), "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 0 and "refused" in out.stdout, out.stderr


def _dtensor_slices(shape, mesh, placements):
    """DTensor's own local slice at this rank's coordinate."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    lshape, off = compute_local_shape_and_global_offset(shape, mesh, placements)
    return tuple(slice(o, o + n) for o, n in zip(off, lshape))


def _expect(shape, mesh, pl, c):
    """The hand split at coordinate c, and DTensor's own where c is this rank's."""
    want = _chunk_slices(shape, [repr(p) for p in pl], c, tuple(mesh.shape))
    if tuple(c) == tuple(mesh.get_coordinate()):
        assert want == _dtensor_slices(shape, mesh, pl)
    return want


@pytest.mark.parametrize("arch", ["granite-3-8b", "grok-1-314b", "whisper-small", "falcon-mamba-7b"])
def test_placements_and_local_slices_on_the_multi_pod_mesh(fake512, arch):
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    rules = _rules(arch, True)[1]
    named = dict(tlm.meta_params(get_config(arch)).named_parameters())
    rs = np.random.default_rng(3)
    coords = [tuple(int(rs.integers(0, n)) for n in (2, 16, 16)) for _ in range(6)] + [(0, 0, 0), (1, 15, 15)]
    for name, spec in tsh.named_pspecs(named, rules).items():
        pl = tsh.to_placements(spec, mesh)
        for dim, entry in enumerate(spec):
            for ax in tsh._mesh_axes(entry):
                assert pl[mesh.mesh_dim_names.index(ax)] == Shard(dim)
        used = {a for e in spec for a in tsh._mesh_axes(e)}
        assert all(pl[i] == Replicate() for i, a in enumerate(mesh.mesh_dim_names) if a not in used)
        for c in coords:
            assert tsh.local_slices(named[name].shape, mesh, pl, c) == _expect(named[name].shape, mesh, pl, c)


def test_uneven_and_nested_slices_follow_dtensor(fake512):
    from torch.distributed.tensor import Replicate, Shard

    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    cases = [((5, 7), (Replicate(), Shard(1), Shard(0))), ((3,), (Shard(0), Shard(0), Shard(0))),
             ((49155, 4096), (Replicate(), Shard(1), Shard(0))), ((1500, 17), (Shard(0), Shard(0), Shard(1)))]
    for shape, pl in cases:
        for c in ((0, 0, 0), (1, 7, 3), (1, 15, 15), (0, 2, 9)):
            assert tsh.local_slices(shape, mesh, pl, c) == _expect(shape, mesh, pl, c)
    with pytest.raises(ValueError):
        tsh.to_placements((("data", "pod"),), mesh)  # not the mesh's order
    with pytest.raises(ValueError):
        tsh.to_placements(("expert",), mesh)
    with pytest.raises(ValueError):
        tsh.local_slices((4, 4), mesh, (Shard(2), Replicate(), Replicate()))


def test_constrain(fake512):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.randn(4, 6)
    assert tsh.constrain(x, tsh.DEFAULT_RULES, "dp", "tensor") is x
    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    d = tsh.shard_tensor(torch.empty(64, 32, 16, device="meta"), mesh, (Replicate(), Replicate(), Replicate()))
    assert tsh.constrain(d, None, "dp") is d
    rules = tmesh.production_rules(multi_pod=True)
    y = tsh.constrain(d, rules, "dp", "sp")
    assert isinstance(y, DTensor) and tuple(y.placements) == (Shard(0), Shard(0), Shard(1))
    assert tuple(y.to_local().shape) == (2, 2, 16)
    assert tuple(tsh.constrain(y, rules, "dp", "sp").placements) == tuple(y.placements)
    # Already placed, the point still pins the gradient that comes back through it.
    w = y.detach().requires_grad_(True)
    tsh.constrain(w, rules, "dp", "sp").backward(d)
    assert tuple(w.grad.placements) == (Shard(0), Shard(0), Shard(1))


# ------------------------------------------------------------------ 4 gloo ranks


def _reference_checkpoints(tmp) -> dict:
    """The reference's checkpoints the ranks restore, written by its
    ``save_checkpoint``; returns their trees as numpy arrays."""
    jcfg = dataclasses.replace(jget("granite-3-8b").reduced(), dtype="bfloat16", **sw.TINY)
    state = jstate.init_train_state(jcfg, JAdamW(), jax.random.PRNGKey(4))
    rs = np.random.default_rng(5)
    rand = lambda x: jnp.asarray(rs.standard_normal(x.shape).astype(np.float32))
    state["opt"]["mu"] = jax.tree_util.tree_map(rand, state["opt"]["mu"])
    state["opt"]["nu"] = jax.tree_util.tree_map(rand, state["opt"]["nu"])
    state["opt"]["count"] = jnp.asarray(3, jnp.int32)
    state["step"] = jnp.asarray(3, jnp.int32)
    jck.save_checkpoint(str(tmp / "state"), sw.STATE_STEP, state)
    params32 = jlm.init_params(dataclasses.replace(jcfg, dtype="float32"), jax.random.PRNGKey(6))
    jck.save_checkpoint(str(tmp / "params"), sw.PARAMS_STEP, params32)
    state32 = jstate.init_train_state(dataclasses.replace(jcfg, dtype="float32"), JAdamW(), jax.random.PRNGKey(8))
    state32["opt"]["mu"] = jax.tree_util.tree_map(lambda x: 1e-3 * rand(x), state32["opt"]["mu"])
    state32["opt"]["nu"] = jax.tree_util.tree_map(lambda x: 1e-6 * jnp.abs(rand(x)), state32["opt"]["nu"])
    state32["opt"]["count"] = jnp.asarray(2, jnp.int32)
    state32["step"] = jnp.asarray(2, jnp.int32)
    jck.save_checkpoint(str(tmp / "state32"), sw.STATE32_STEP, state32)
    uneven = {}
    for k, (shape, dt, _) in sw.UNEVEN.items():
        a = rs.standard_normal(shape).astype(np.float32)
        uneven[k] = jnp.asarray(a, jnp.bfloat16 if dt == "bfloat16" else jnp.float32)
    jck.save_checkpoint(str(tmp / "uneven"), sw.UNEVEN_STEP, uneven)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return {"state": to_np(state), "params": to_np(params32), "uneven": to_np(uneven)}


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("sharding4")
    ref = _reference_checkpoints(tmp)
    world = 4
    ctx = mp.start_processes(sw.run_rank, args=(world, str(tmp / "rendezvous"), str(tmp), str(tmp / "state"),
                                                str(tmp / "params"), str(tmp / "uneven"), str(tmp / "state32")),
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
    return ref, [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)], tmp


def _chunk_slices(shape, placements, coord, mesh_shape=sw.MESH) -> tuple:
    """DTensor's split computed here by hand: each sharding mesh dim in order
    cuts the piece left by the ones before it with torch.chunk's rule."""
    bounds = [[0, n] for n in shape]
    for i, p in enumerate(placements):
        if p.startswith("Shard"):
            d = int(p[p.index("=") + 1 : p.index(")")])
            lo, hi = bounds[d]
            step = -(-(hi - lo) // mesh_shape[i])
            s = min(coord[i] * step, hi - lo)
            bounds[d] = [lo + s, lo + min(s + step, hi - lo)]
    return tuple(slice(a, b) for a, b in bounds)


def _as_np(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _ref_leaf(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return np.asarray(node)


def test_elastic_restore_of_a_reference_checkpoint_is_bitwise_per_rank_and_gathered(gloo_run):
    ref, ranks, _ = gloo_run
    assert sorted(tuple(r["coordinate"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    n_sharded = 0
    for r in ranks:
        coord = r["coordinate"]
        for key, e in r["shards"].items():
            path, i = key.rsplit("/", 1)
            want = _ref_leaf(ref["state"], path)
            if e["stacked"]:
                want = want[int(i)]
            assert np.array_equal(_as_np(e["full"]), want, equal_nan=True), key
            sl = _chunk_slices(want.shape, e["placements"], coord)
            assert _as_np(e["local"]).shape == want[sl].shape, key
            assert np.array_equal(_as_np(e["local"]), want[sl]), key
            n_sharded += any(p.startswith("Shard") for p in e["placements"])
    assert n_sharded > 0


def test_elastic_restore_splits_uneven_leaves_as_torch_chunk(gloo_run):
    ref, ranks, _ = gloo_run
    for r in ranks:
        for k, e in r["uneven"].items():
            want = ref["uneven"][k]
            spec = sw.UNEVEN[k][2]
            pl = [repr(p) for p in _placements_by_hand(spec)]
            assert np.array_equal(_as_np(e["full"]), want)
            assert np.array_equal(_as_np(e["local"]), want[_chunk_slices(want.shape, pl, r["coordinate"])])


def _placements_by_hand(spec):
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate(), Replicate()]
    for dim, entry in enumerate(spec):
        for ax in tsh._mesh_axes(entry):
            out[("data", "model").index(ax)] = Shard(dim)
    return out


def test_sharded_loss_on_a_gloo_mesh_matches_one_process(gloo_run):
    ref, ranks, _ = gloo_run
    cfg = sw.port_config("float32")
    params = tlm.params_from_reference(cfg, ref["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in sw.batch_arrays(cfg.vocab_size).items()}
    with torch.no_grad():
        want, _ = tlm.lm_loss(params, cfg, batch, plan=tlm.ExecPlan(remat="none"))
    for r in ranks:
        assert abs(float(r["loss"]) - float(want)) <= LOSS_TOL * abs(float(want))
    assert len({float(r["loss"]) for r in ranks}) == 1


@pytest.fixture(scope="module")
def one_process_step(gloo_run):
    """One process's step from the float32 train state checkpoint (the port's
    plain restore of the reference's files), on the ranks' batch."""
    from repro_torch.checkpoint import store
    from repro_torch.train import step as tstep

    _, _, tmp = gloo_run
    cfg = sw.port_config("float32")
    opt = AdamWConfig()
    like = tstate.checkpoint_tree(tstate.train_state_shapes(cfg, opt))
    state = tstate.state_from_tree(cfg, store.restore_checkpoint(str(tmp / "state32"), sw.STATE32_STEP, like),
                                   device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in sw.batch_arrays(cfg.vocab_size).items()}
    state, metrics = tstep.make_train_step(cfg, opt, plan=tlm.ExecPlan(remat="none"))(state, batch)
    return state, metrics


def test_sharded_train_step_on_a_gloo_mesh_matches_one_process(gloo_run, one_process_step):
    _, ranks, _ = gloo_run
    state, metrics = one_process_step
    close = lambda got, want: torch.all((got - want).abs() <= STEP_TOL * (1 + want.abs())).item()
    for r in ranks:
        s = r["step"]
        assert s["sharded"] > 0
        assert s["grad_placements"] == s["param_placements"]
        assert {k.split("/", 1)[1]: v for k, v in s["moments_after"].items() if k.startswith("mu/")} == \
            s["param_placements"]
        assert s["moments_after"] == s["moments_before"]
        for name, p in state["params"].named_parameters():
            assert close(s["params"][name], p.detach()), name
            assert close(s["mu"][name], state["opt"]["mu"][name]), name
            assert close(s["nu"][name], state["opt"]["nu"][name]), name
        assert int(s["count"]) == int(state["opt"]["count"]) == 3
        assert close(s["loss"], metrics["loss"]) and close(s["grad_norm"], metrics["grad_norm"])
    assert len({float(r["step"]["loss"]) for r in ranks}) == 1


@pytest.mark.parametrize("arch", PORTED)
def test_sharded_gradients_of_each_config_match_one_process(gloo_run, arch):
    from repro_torch.utils import prng

    _, ranks, _ = gloo_run
    cfg = get_config(arch).reduced()
    params = tlm.init_params(cfg, prng.prng_key(1), device="cpu")
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in sw.family_batch(cfg).items()}
    loss, _ = tlm.lm_loss(params, cfg, batch, plan=tlm.ExecPlan(**sw.FAMILY_PLAN))
    loss.backward()
    want = float(loss.detach())
    for r in ranks:
        got = r["families"][arch]
        assert abs(float(got["loss"]) - want) <= LOSS_TOL * abs(want)
        for name, p in params.named_parameters():
            scale = p.grad.abs().max()
            assert scale > 0, name
            assert (got["grads"][name] - p.grad).abs().max() <= GRAD_TOL * scale, name


def test_a_restore_whose_placements_do_not_fit_raises(fake512, tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint import store

    mesh = tmesh.make_production_mesh(multi_pod=True, device_type="cpu")
    tree = {"layers": {"w": tu.Stacked((torch.ones(4, 6), torch.zeros(4, 6)))}, "b": torch.arange(5.0)}
    store.save_checkpoint(str(tmp_path), 1, tree)
    R = Replicate()
    fits = {"layers": {"w": (R, Shard(1), Shard(2))}, "b": (R, R, Shard(0))}
    got = store.restore_checkpoint(str(tmp_path), 1, tree, mesh=mesh, placements=fits)
    assert tuple(got["layers"]["w"].parts[0].placements) == (R, Shard(0), Shard(1))
    bad = [{"layers": {"w": (Shard(0), R, R)}, "b": (R, R, R)},  # the layer axis sharded
           {"layers": {"w": (R, R)}, "b": (R, R, R)},             # two placements, three mesh dims
           {"layers": {"w": (R, R, R)}, "b": (R, R, Shard(1))}]   # a dimension b lacks
    for placements in bad:
        with pytest.raises(ValueError):
            store.restore_checkpoint(str(tmp_path), 1, tree, mesh=mesh, placements=placements)
    with pytest.raises(KeyError):
        store.restore_checkpoint(str(tmp_path), 1, tree, mesh=mesh, placements={"b": (R, R, R)})
    with pytest.raises(ValueError):
        store.restore_checkpoint(str(tmp_path), 1, tree, mesh=mesh)
