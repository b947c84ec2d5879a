"""Shared pieces of the LM training parity tests: the reference's tiny test config
(``tests/test_train_loop.py``: 2 layers, d 32, vocab 97, float32) and the
reduced mixtral-8x7b (float32) in both packages, the port's train state from the reference's, and the lookup of a port
parameter name in a reference tree. Imports JAX: tests only."""
import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get_config as jget
from repro_torch.configs import get_config as tget
from repro_torch.models import lm as tlm
from repro_torch.optim import init_opt_state
from repro_torch.utils import prng as tprng

LR, EPS = 1e-3, 1e-4  # AdamW of the parity tests: eps 1e-4 keeps the update Lipschitz in the gradient
TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1, head_dim=16, vocab_size=97)
BATCH, SEQ = 4, 32


def configs():
    """(reference cfg, port cfg) of the tiny test model."""
    return (dataclasses.replace(jget("granite-3-8b").reduced(), **TINY),
            dataclasses.replace(tget("granite-3-8b").reduced(), **TINY))


def moe_configs():
    """(reference cfg, port cfg) of the reduced mixtral-8x7b in float32: 2 layers,
    d 64, 4 experts, top-2 at capacity 1.25, window 8."""
    return (dataclasses.replace(jget("mixtral-8x7b").reduced(), dtype="float32"),
            dataclasses.replace(tget("mixtral-8x7b").reduced(), dtype="float32"))


def ref_leaf(tree, name: str) -> np.ndarray:
    """The reference tree's value of the port parameter ``name``
    (``layers.<l>.attn.wq`` → ``tree["layers"]["attn"]["wq"][l]``)."""
    parts = name.split(".")
    if parts[0] == "layers":
        node = tree["layers"]
        for p in parts[2:]:
            node = node[p]
        return np.asarray(node[int(parts[1])], np.float32)
    node = tree
    for p in parts:
        node = node[p]
    return np.asarray(node, np.float32)


def port_state(tcfg, jparams, opt_cfg) -> dict:
    """The port's train state holding the reference's parameters, zero moments, step 0."""
    params = tlm.params_from_reference(tcfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    params.requires_grad_(True)
    return {"params": params, "opt": init_opt_state(opt_cfg, params), "step": torch.zeros((), dtype=torch.int32)}


def max_rel(state_params, jparams) -> float:
    """max over parameters of max |port − reference| / max |reference|."""
    worst = 0.0
    for name, p in state_params.named_parameters():
        want = ref_leaf(jparams, name)
        worst = max(worst, float(np.abs(p.detach().numpy() - want).max() / max(np.abs(want).max(), 1e-30)))
    return worst


_REF_STEPS: dict = {}


def reference_sketch_dp_step(jcfg, jopt, comp):
    """The reference's jitted ``make_sketch_dp_step`` on a 1-device mesh, made
    once per (config, optimizer, compressor) in this process."""
    from repro.train import sketch_dp

    key = (jcfg, jopt, comp)
    if key not in _REF_STEPS:
        _REF_STEPS[key] = sketch_dp.make_sketch_dp_step(jcfg, jopt, jax.make_mesh((1,), ("data",)), comp=comp)
    return _REF_STEPS[key]


def port_key(jkey) -> torch.Tensor:
    return tprng.from_key_data(np.asarray(jax.random.key_data(jkey)))
