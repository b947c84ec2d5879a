"""Rank bodies and shared inputs for ``tests/test_torch_sharding.py``.

Kept apart from the test module so that a spawned rank imports only torch and
the port, never JAX. Each rank joins a gloo group of 4, builds the (2, 2)
("data", "model") CPU mesh, restores the reference's checkpoints onto it with
``elastic_restore``, computes the narrow model's loss on DTensors under the
production rules, takes one sharded train step (``make_train_step`` with
``rules``) from a restored float32 train state, and takes the loss and the
gradients of every config's reduced form on DTensors (``family_grads``); its
results go to ``rank<r>.pt``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

# The reference's tiny test model (tests/_torch_lm_train.py), narrow and 2 layers deep.
TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1, head_dim=16, vocab_size=97)
BATCH, SEQ = 4, 32
MESH = (2, 2)
# The reduced configs' plan: chunks shorter than SEQ, so the chunk loops run more than once.
FAMILY_PLAN = dict(remat="none", attn_chunk=16, loss_chunk=16, ssm_chunk=16)
# The checkpoints' steps: the bf16 train state, the float32 parameters, the uneven leaves, the float32 train state.
STATE_STEP, PARAMS_STEP, UNEVEN_STEP, STATE32_STEP = 3, 5, 7, 9
# Leaves no mesh axis divides, with their specs: DTensor's torch.chunk split.
UNEVEN = {"a": ((5, 7), "float32", ("model", "data")), "b": ((3,), "bfloat16", (("data", "model"),)),
          "c": ((2, 3, 5), "float32", (None, "data", "model"))}


def port_config(dtype: str):
    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("granite-3-8b").reduced(), dtype=dtype, **TINY)


def batch_arrays(vocab: int) -> dict:
    """The loss's batch: tokens and labels from a fixed seed, a loss mask with zeros."""
    rs = np.random.default_rng(21)
    tokens = rs.integers(0, vocab, (BATCH, SEQ), dtype=np.int32)
    mask = (rs.random((BATCH, SEQ)) > 0.2).astype(np.float32)
    return {"tokens": tokens, "labels": tokens.copy(), "loss_mask": mask}


def family_batch(cfg) -> dict:
    """A reduced config's training batch (its ``input_specs`` at BATCH × SEQ):
    tokens and labels, a loss mask with zeros, N(0, 1) frames or patches."""
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.specs import input_specs

    rs = np.random.default_rng(23)
    out = batch_arrays(cfg.vocab_size)
    for k, v in input_specs(cfg, ShapeSpec("tiny", SEQ, BATCH, "train")).items():
        if k not in out:
            out[k] = rs.standard_normal(tuple(v.shape)).astype(np.float32)
    return out


def family_grads(mesh, rules) -> dict:
    """For each config of ``PORTED`` reduced, its weights for key 1 placed by
    ``rules`` on ``mesh``: the loss and each gradient (redistributed to its
    parameter's placements, as the train step does), gathered."""
    import torch

    from repro_torch.configs import PORTED, get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.specs import batch_pspecs
    from repro_torch.distributed import sharding
    from repro_torch.models import lm
    from repro_torch.train import step as tstep
    from repro_torch.utils import prng

    out = {}
    for arch in PORTED:
        cfg = get_config(arch).reduced()
        named = {n: p.detach() for n, p in lm.init_params(cfg, prng.prng_key(1), device="cpu").named_parameters()}
        specs = sharding.named_pspecs(named, rules)
        params = lm.params_from_named(cfg, {n: sharding.shard_tensor(t, mesh, sharding.to_placements(specs[n], mesh))
                                            for n, t in named.items()})
        params.requires_grad_(True)
        bspecs = batch_pspecs(cfg, ShapeSpec("tiny", SEQ, BATCH, "train"), rules)
        batch = {k: sharding.shard_tensor(torch.from_numpy(v), mesh, sharding.to_placements(bspecs[k], mesh))
                 for k, v in family_batch(cfg).items()}
        with lm.sharded_region(params):
            loss, _ = lm.lm_loss(params, cfg, batch, rules=rules, plan=lm.ExecPlan(**FAMILY_PLAN))
            loss.backward()
        grads = tstep._constrain_like_params(tstep.take_grads(params), rules)
        out[arch] = {"loss": loss.detach().full_tensor(), "grads": {n: g.full_tensor() for n, g in grads.items()}}
    return out


def run_rank(rank: int, world: int, init_file: str, out_dir: str, state_dir: str, params_dir: str,
             uneven_dir: str, state32_dir: str) -> None:
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.specs import batch_pspecs
    from repro_torch.distributed import sharding
    from repro_torch.distributed.fault_tolerance import elastic_restore
    from repro_torch.launch.mesh import production_rules
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import state as tstate
    from repro_torch.utils import tree as tu

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", MESH, mesh_dim_names=("data", "model"))
        rules = production_rules()
        out = {"coordinate": list(mesh.get_coordinate())}

        cfg = port_config("bfloat16")
        opt = AdamWConfig()
        like = tstate.checkpoint_tree(tstate.train_state_shapes(cfg, opt))
        restored = elastic_restore(state_dir, STATE_STEP, like, mesh, tstate.train_state_pspecs(cfg, opt, rules))
        shards = {}
        for path, leaf in tu.tree_flatten_with_path(restored)[0]:
            parts = leaf.parts if isinstance(leaf, tu.Stacked) else (leaf,)
            for i, t in enumerate(parts):
                shards[f"{tu.path_str(path)}/{i}"] = {
                    "local": t.to_local().clone(), "full": t.full_tensor(),
                    "placements": [repr(p) for p in t.placements], "stacked": isinstance(leaf, tu.Stacked)}
        out["shards"] = shards

        like_u = {k: torch.empty(shape, device="meta") for k, (shape, _, _) in UNEVEN.items()}
        uneven = elastic_restore(uneven_dir, UNEVEN_STEP, like_u, mesh, {k: spec for k, (_, _, spec) in UNEVEN.items()})
        out["uneven"] = {k: {"local": t.to_local().clone(), "full": t.full_tensor()} for k, t in uneven.items()}

        cfg32 = port_config("float32")
        pl = tstate.checkpoint_tree(tstate.train_state_shapes(cfg32, opt))["params"]
        params_tree = elastic_restore(params_dir, PARAMS_STEP, pl, mesh, sharding.param_pspecs(pl, rules))
        params = lm.params_from_named(cfg32, tu.unstack_tree(params_tree))
        arrays = batch_arrays(cfg32.vocab_size)
        specs = batch_pspecs(cfg32, ShapeSpec("tiny", SEQ, BATCH, "train"), rules)
        batch = {k: sharding.shard_tensor(torch.from_numpy(v), mesh, sharding.to_placements(specs[k], mesh))
                 for k, v in arrays.items()}
        loss, parts = lm.lm_loss(params, cfg32, batch, rules=rules, plan=lm.ExecPlan(remat="none"))
        out["loss"] = loss.full_tensor()
        out["ce"] = parts["ce"].full_tensor()
        out["step"] = _sharded_step(cfg32, opt, mesh, rules, state32_dir, batch)
        out["families"] = family_grads(mesh, rules)
        torch.save(out, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _sharded_step(cfg, opt, mesh, rules, state_dir: str, batch: dict) -> dict:
    """One ``make_train_step(rules=)`` step from the float32 train state restored
    onto ``mesh``: the placements of the gradients AdamW receives beside their
    parameters', the moments' placements before and after, and the updated
    state gathered."""
    import torch

    from repro_torch.distributed.fault_tolerance import elastic_restore
    from repro_torch.models import lm
    from repro_torch.train import state as tstate
    from repro_torch.train import step as tstep
    from repro_torch.utils import tree as tu

    like = tstate.checkpoint_tree(tstate.train_state_shapes(cfg, opt))
    restored = elastic_restore(state_dir, STATE32_STEP, like, mesh, tstate.train_state_pspecs(cfg, opt, rules))
    state = tstate.state_from_tree(cfg, restored, device="cpu")
    params = state["params"]
    placed = lambda t: [repr(p) for p in t.placements]
    param_pl = {n: placed(p) for n, p in params.named_parameters()}
    moments_before = {f"{m}/{n}": placed(t) for m in ("mu", "nu") for n, t in state["opt"][m].items()}
    seen = {}
    update = tstep.adamw_update

    def spy(cfg_, params_, grads, opt_state, **kw):
        seen.update({n: placed(g) for n, g in grads.items()})
        return update(cfg_, params_, grads, opt_state, **kw)

    tstep.adamw_update = spy
    try:
        state, metrics = tstep.make_train_step(cfg, opt, rules=rules, plan=lm.ExecPlan(remat="none"))(state, batch)
    finally:
        tstep.adamw_update = update
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t
    return {"param_placements": param_pl, "grad_placements": seen, "moments_before": moments_before,
            "moments_after": {f"{m}/{n}": placed(t) for m in ("mu", "nu") for n, t in state["opt"][m].items()},
            "params": {n: full(p.detach()) for n, p in params.named_parameters()},
            "mu": {n: full(t) for n, t in state["opt"]["mu"].items()},
            "nu": {n: full(t) for n, t in state["opt"]["nu"].items()},
            "count": full(state["opt"]["count"]), "loss": full(metrics["loss"]),
            "grad_norm": full(metrics["grad_norm"]), "sharded": sum(any("Shard" in q for q in v)
                                                                    for v in param_pl.values())}
