"""The port's sketch-DP training step against the JAX reference (CPU, float32).

The reference's tiny test model (``tests/_torch_lm_train.py``), its weights for
key 0, ``lm_batch`` of 4 × 32 tokens a step, keys ``fold_in(PRNGKey(1), step)``.

* One process: two steps of ``make_sketch_dp_step`` (``group=None``) against
  the reference's on ``jax.make_mesh((1,), ("data",))``, with compression off,
  the CountSketch (ratio 0.1) and the Gaussian (ratio 0.002: m = 70, the port's
  CPU S is m·D threefry draws), and the
  CountSketch with this worker's mask 0 (a straggler: a zero gradient, decay
  alone moves the weights); and the CountSketch on the reduced mixtral-8x7b
  (float32, 4 experts, top-2 at capacity 1.25: its loss carries the MoE
  auxiliary term, and its gradient the backward of the expert dispatch). Losses within LOSS_TOL, parameters after each step
  within STEP_TOL of each leaf's largest entry. Both packages draw the same S
  (the counter RNG), so the sketch adds no difference of its own; AdamW's eps
  is 1e-4, so the update is Lipschitz in the gradient.
* The flat gradient vector: ``.grad`` values written by ``flatten_grads``
  equal the reference's ``tree_flatten_to_vector`` of the same values bit for
  bit (its coordinate order: sorted paths, stacked layers one after another;
  an MoE tree's ``moe.router``, ``w_down``, ``w_gate``, ``w_up`` between ``attn``
  and ``norm1``), on the tiny model and the reduced mixtral, and every
  ``.grad`` is freed.
* Two gloo ranks (``tests/_torch_train_worker.py``) against the reference's
  2-device mesh in a subprocess: two CountSketch steps with masks (1, 1) and
  (1, 0); both ranks hold the same parameters bit for bit, within STEP_TOL of
  the reference's.
"""
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_train as lt
import _torch_train_worker as tw
from repro.core import gradcomp as jgc
from repro.data import tokens as jtok
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamW, init_opt_state as jinit_opt
from repro.utils import tree as jtree
from repro_torch.core import gradcomp as tgc
from repro_torch.data import tokens as ttok
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.train import sketch_dp as tsdp

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_TOL = 1e-6
STEP_TOL = 2e-5
LR, EPS = lt.LR, lt.EPS
CASES = {"off": (dict(enabled=False), 1.0, "tiny"), "countsketch": (dict(enabled=True, ratio=0.1), 1.0, "tiny"),
         "gaussian": (dict(enabled=True, ratio=0.002, kind="gaussian"), 1.0, "tiny"),
         "countsketch_straggler": (dict(enabled=True, ratio=0.1), 0.0, "tiny"),
         "moe_countsketch": (dict(enabled=True, ratio=0.1), 1.0, "moe")}
SPAWN_TIMEOUT_S = 300


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = lt.configs()
    return jcfg, tcfg, jlm.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.fixture(scope="module")
def moe():
    jcfg, tcfg = lt.moe_configs()
    return jcfg, tcfg, jlm.init_params(jcfg, jax.random.PRNGKey(0))


@pytest.mark.parametrize("case", list(CASES))
def test_sketch_dp_steps_match_reference(request, case):
    comp, m0, model = CASES[case]
    jcfg, tcfg, jparams = request.getfixturevalue(model)
    mask = np.array([m0, 1.0, 0.0, 1.0], np.float32)
    jopt, topt = JAdamW(lr=LR, eps=EPS), TAdamW(lr=LR, eps=EPS)
    jstep = lt.reference_sketch_dp_step(jcfg, jopt, jgc.GradCompressionConfig(**comp))
    tstep = tsdp.make_sketch_dp_step(tcfg, topt, comp=tgc.GradCompressionConfig(**comp))
    jst = {"params": jparams, "opt": jinit_opt(jopt, jparams), "step": jnp.zeros((), jnp.int32)}
    st = lt.port_state(tcfg, jparams, topt)
    for s in range(2):
        jkey = jax.random.fold_in(jax.random.PRNGKey(1), s)
        jbatch = jtok.lm_batch(0, s, batch=lt.BATCH, seq=lt.SEQ, vocab=jcfg.vocab_size)
        tbatch = ttok.lm_batch(0, s, batch=lt.BATCH, seq=lt.SEQ, vocab=tcfg.vocab_size, device="cpu")
        jst, jm = jstep(jst, jbatch, jkey, jnp.asarray(mask))
        st, m = tstep(st, tbatch, lt.port_key(jkey), torch.from_numpy(mask))
        assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * max(abs(float(jm["loss"])), 1.0), s
        assert lt.max_rel(st["params"], jst["params"]) <= STEP_TOL, s
        assert all(p.grad is None for p in st["params"].parameters())
    assert int(st["step"]) == 2 and int(st["opt"]["count"]) == 2


@pytest.mark.parametrize("model", ["tiny", "moe"])
def test_flat_gradient_vector_is_the_reference_order_bitwise(request, model):
    jcfg, tcfg, jparams = request.getfixturevalue(model)
    st = lt.port_state(tcfg, jparams, TAdamW())
    rs = np.random.default_rng(9)
    gtree = jax.tree_util.tree_map(lambda a: rs.standard_normal(a.shape).astype(np.float32), jparams)
    for name, p in st["params"].named_parameters():
        p.grad = torch.from_numpy(lt.ref_leaf(gtree, name).copy())
    vec, offsets = tsdp.flatten_grads(st["params"])
    want, _ = jtree.tree_flatten_to_vector(jax.tree_util.tree_map(jnp.asarray, gtree))
    np.testing.assert_array_equal(vec.numpy(), np.asarray(want))
    assert all(p.grad is None for p in st["params"].parameters())
    paths = [path for path, _ in tsdp.grad_layout(st["params"])]
    assert paths == ["/".join(k.key for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]]
    assert sum(n for _, n in offsets.values()) == vec.numel()


_REFERENCE_MESH = """
import sys
sys.path.insert(0, {tests!r})
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import _torch_lm_train as lt
import _torch_train_worker as tw
from repro.core import gradcomp
from repro.data import tokens
from repro.models import lm
from repro.optim import AdamWConfig, init_opt_state
from repro.train import sketch_dp

mesh = Mesh(np.array(jax.devices()), ("data",))
assert mesh.shape["data"] == tw.WORLD
jcfg, _ = lt.configs()
params = lm.init_params(jcfg, jax.random.PRNGKey(0))
opt = AdamWConfig(lr=tw.LR, eps=tw.EPS)
st = {{"params": params, "opt": init_opt_state(opt, params), "step": jnp.zeros((), jnp.int32)}}
step = sketch_dp.make_sketch_dp_step(jcfg, opt, mesh,
                                     comp=gradcomp.GradCompressionConfig(enabled=True, ratio=tw.RATIO))
losses = []
for s in range(tw.STEPS):
    batch = tokens.lm_batch(0, s, batch=tw.BATCH, seq=tw.SEQ, vocab=jcfg.vocab_size)
    st, m = step(st, batch, jax.random.fold_in(jax.random.PRNGKey(tw.BASE_KEY), s), jnp.asarray(tw.MASKS[s]))
    losses.append(float(m["loss"]))
out = {{"losses": np.array(losses)}}
for path, leaf in jax.tree_util.tree_flatten_with_path(st["params"])[0]:
    out["/".join(k.key for k in path)] = np.asarray(leaf)
np.savez({dest!r}, **out)
"""


def _spawn_ranks(tmp_path) -> list:
    import torch.multiprocessing as mp

    ctx = mp.start_processes(tw.run_rank, args=(tw.WORLD, str(tmp_path / "rendezvous"), str(tmp_path)),
                             nprocs=tw.WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{tw.WORLD} gloo ranks did not finish within {SPAWN_TIMEOUT_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(timeout=10)
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(tw.WORLD)]


@pytest.mark.subprocess
def test_two_gloo_ranks_match_the_reference_mesh(tmp_path):
    dest = tmp_path / "reference.npz"
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={tw.WORLD}")
    script = _REFERENCE_MESH.format(tests=os.path.join(ROOT, "tests"), dest=str(dest))
    ref_proc = subprocess.Popen([sys.executable, "-c", script], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                text=True, env=env)
    try:
        ranks = _spawn_ranks(tmp_path)
        out, err = ref_proc.communicate(timeout=SPAWN_TIMEOUT_S)
    finally:
        if ref_proc.poll() is None:
            ref_proc.kill()
            ref_proc.communicate()
    assert ref_proc.returncode == 0, f"STDOUT:\n{out}\nSTDERR:\n{err}"
    ref = dict(np.load(dest))
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=LOSS_TOL)
    for key, got in ranks[0].items():
        if not key.startswith("p:"):
            continue
        np.testing.assert_array_equal(got, ranks[1][key])
        name = key[2:]
        parts = name.split(".")
        want = ref["/".join([parts[0]] + parts[2:])][int(parts[1])] if parts[0] == "layers" else ref[name.replace(".", "/")]
        assert np.abs(got - want).max() <= STEP_TOL * np.abs(want).max(), name
