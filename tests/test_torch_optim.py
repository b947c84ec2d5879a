"""The port's optimizer against the JAX reference (CPU).

Schedules: the three schedules over steps 0…60 at OPT_TOL of the reference's
(float32 arithmetic in the same order; ``cos`` may differ by an ulp).
``adamw_update``: two steps on a float32 and a bfloat16 tree (stacked layer
leaves, norms, an embedding), with and without the global-norm clip, weight
decay on, a float32 schedule scale. float32 parameters and moments agree within
OPT_TOL relative to the largest entry (the global norm sums in another order,
which moves the clip's scale by an ulp); bfloat16 parameters within one bf16
ulp (2⁻⁸ relative) of the reference's: a float32 value an ulp off can round the
other way. The leaves that weight decay reaches are the reference's: on a
module the path strings come from the state-dict names (``layers.<l>.norm1.scale``
→ ``layers/norm1/scale``), and a step with zero gradients moves exactly the
decayed leaves in both packages.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.configs import get_config as jget
from repro.models import lm as jlm
from repro_torch import optim as topt
from repro_torch.configs import get_config as tget
from repro_torch.models import lm as tlm
from repro_torch.utils import prng as tprng, tree as tu

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

OPT_TOL = 1e-6
SHAPES = {"embed": {"table": (20, 8)}, "final_norm": {"scale": (8,)},
          "layers": {"attn": {"wq": (3, 8, 16)}, "norm1": {"scale": (3, 8)}}, "unembed": {"w": (8, 20)}}


def _tree(rs, scale):
    return jax.tree_util.tree_map(lambda s: (rs.standard_normal(s) * scale).astype(np.float32), SHAPES,
                                  is_leaf=lambda x: isinstance(x, tuple))


def _to_torch(tree, dtype):
    return tu.tree_map(lambda a: torch.from_numpy(np.array(a, np.float32)).to(dtype), tree)


def _to_jax(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a).astype(dtype), tree)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) \
        else x.to(torch.float32).numpy()


@pytest.mark.parametrize("name", ["constant", "linear", "warmup_cosine"])
def test_schedules_match_reference(name):
    make = {"constant": lambda m: m.constant_schedule(), "linear": lambda m: m.linear_schedule(40, 0.2),
            "warmup_cosine": lambda m: m.linear_warmup_cosine(5, 50, 0.1)}[name]
    js, ts = make(jopt), make(topt)
    for s in range(61):
        want = float(js(jnp.asarray(s, jnp.int32)))
        got = ts(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= OPT_TOL * max(abs(want), 1e-30), (s, float(got), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [0.0, 1.0])
def test_adamw_update_matches_reference(dtype, clip):
    rs = np.random.default_rng(3)
    params = _tree(rs, 0.5)
    grads = [_tree(rs, 2.0) for _ in range(2)]
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bfloat16" else (jnp.float32, torch.float32)
    cfg_j = jopt.AdamWConfig(lr=1e-2, grad_clip=clip, weight_decay=0.1)
    cfg_t = topt.AdamWConfig(lr=1e-2, grad_clip=clip, weight_decay=0.1)
    jp = _to_jax(params, jdt)
    jst = jopt.init_opt_state(cfg_j, jp)
    tp = _to_torch(params, tdt)
    tst = topt.init_opt_state(cfg_t, tp)
    sched_j, sched_t = jopt.linear_warmup_cosine(1, 10), topt.linear_warmup_cosine(1, 10)
    for i, g in enumerate(grads):
        jp, jst, jm = jopt.adamw_update(cfg_j, jp, _to_jax(g, jdt), jst, lr_scale=sched_j(jnp.asarray(i + 1)))
        tp, tst, tm = topt.adamw_update(cfg_t, tp, _to_torch(g, tdt), tst, lr_scale=sched_t(torch.tensor(i + 1)))
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=OPT_TOL)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=OPT_TOL)
    assert int(tst["count"]) == int(jst["count"]) == 2
    for want, got in zip(jax.tree_util.tree_leaves(jp), tu.tree_leaves(tp)):
        assert got.dtype == tdt
        w, t = _np(want), _np(got)
        if dtype == "float32":
            assert np.abs(t - w).max() <= OPT_TOL * np.abs(w).max()
        else:
            assert np.all(np.abs(t - w) <= 2.0 ** -8 * np.abs(w))
    for key in ("mu", "nu"):
        for want, got in zip(jax.tree_util.tree_leaves(jst[key]), tu.tree_leaves(tst[key])):
            w, t = _np(want), _np(got)
            assert np.abs(t - w).max() <= 4 * OPT_TOL * np.abs(w).max()


def test_global_norm_clip_matches_reference():
    rs = np.random.default_rng(4)
    g = _tree(rs, 3.0)
    jg, jn = jopt.global_norm_clip(_to_jax(g, jnp.float32), 1.0)
    tg, tn = topt.global_norm_clip(_to_torch(g, torch.float32), 1.0)
    np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_TOL)
    for want, got in zip(jax.tree_util.tree_leaves(jg), tu.tree_leaves(tg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2 * OPT_TOL, atol=1e-9)


def test_no_decay_leaves_are_the_reference_on_the_lm():
    """On the LM module the decayed leaves, by their reference paths, are the
    reference's; a zero-gradient step moves exactly those leaves in both."""
    cfg = dataclasses.replace(tget("granite-3-8b").reduced(), num_layers=2)
    jcfg = dataclasses.replace(jget("granite-3-8b").reduced(), num_layers=2)
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    model = tlm.init_params(cfg, tprng.prng_key(0), device="cpu")
    jopt_cfg, topt_cfg = jopt.AdamWConfig(), topt.AdamWConfig()
    decayed = lambda path: not any(n in path for n in topt_cfg.no_decay)
    ref_paths = {"/".join(str(k.key) for k in path) for path, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    port_paths = {p for p, _ in topt.adamw.leaf_paths(model)}
    assert port_paths == ref_paths
    zeros_j = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    new_j, _, _ = jax.jit(lambda p, g, s: jopt.adamw_update(jopt_cfg, p, g, s))(
        jparams, zeros_j, jopt.init_opt_state(jopt_cfg, jparams))
    moved_j = {"/".join(str(k.key) for k in path) for (path, a), b in zip(
        jax.tree_util.tree_flatten_with_path(jparams)[0], jax.tree_util.tree_leaves(new_j))
        if not np.array_equal(np.asarray(a), np.asarray(b))}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    zeros_t = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    topt.adamw_update(topt_cfg, model, zeros_t, topt.init_opt_state(topt_cfg, model))
    paths = {id(t): p for p, t in topt.adamw.leaf_paths(model)}
    moved_t = {paths[id(p)] for n, p in model.named_parameters() if not torch.equal(p.detach(), before[n])}
    assert moved_t == moved_j == {p for p in ref_paths if decayed(p)}
    assert moved_t == {"embed/table", "layers/attn/wk", "layers/attn/wo", "layers/attn/wq", "layers/attn/wv",
                       "layers/ffn/w_down", "layers/ffn/w_gate", "layers/ffn/w_up", "unembed/w"}
