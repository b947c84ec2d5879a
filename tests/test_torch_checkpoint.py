"""The port's checkpoints, in the reference's on-disk format (CPU).

Round trip of float32, bfloat16 and int32 leaves and of a stacked layer leaf,
bit for bit; ``.tmp`` directories are never a step; a missing leaf raises
KeyError and a wrong shape ValueError; ``AsyncCheckpointer`` snapshots before
``save`` returns (a later in-place write does not reach the file) and keeps the
last ``keep`` steps. Across packages, on the tiny test model in bfloat16 after
one AdamW step: the reference's checkpoint restored by the port, and the
port's restored by the reference, bit for bit, and both write the same
manifest. The reference's weights of the reduced hymba-1.5b (attention, Mamba
and the fuse in every layer) in bfloat16, saved by the reference, restored by
the port bit for bit with the Mamba ``A_log`` float32 beside the bfloat16
leaves; the model built from them is ``params_from_reference``'s.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_train as lt
from repro import checkpoint as jck
from repro.optim import AdamWConfig as JAdamW
from repro.train import state as jstate
from repro_torch import checkpoint as tck
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.train import state as tstate
from repro_torch.utils import tree as tu

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"b": torch.randn(3, 4, generator=g).to(torch.bfloat16), "a": torch.randn(5, generator=g),
            "n": {"i": torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  "s": tu.Stacked((torch.randn(2, 2, generator=g), torch.randn(2, 2, generator=g)))}}


def _equal(a, b) -> bool:
    if isinstance(a, tu.Stacked):
        return all(_equal(x, y) for x, y in zip(a.parts, b.parts))
    return a.dtype == b.dtype and torch.equal(a, b)


def test_round_trip_is_bitwise_including_bf16_and_stacked_leaves(tmp_path):
    tree = _tree()
    path = tck.save_checkpoint(str(tmp_path), 7, tree)
    assert os.path.basename(path) == "step_00000007" and tck.latest_step(str(tmp_path)) == 7
    back = tck.restore_checkpoint(str(tmp_path), 7, tree)
    for x, y in zip(tu.tree_leaves(tree), tu.tree_leaves(back)):
        assert _equal(x, y)
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    assert [e["path"] for e in manifest["leaves"]] == ["a", "b", "n/i", "n/s"]
    assert [e["dtype"] for e in manifest["leaves"]] == ["float32", "bfloat16", "int32", "float32"]
    assert manifest["leaves"][3]["shape"] == [2, 2, 2]


def test_tmp_directories_are_ignored(tmp_path):
    tck.save_checkpoint(str(tmp_path), 3, _tree())
    os.makedirs(tmp_path / "step_00000009.tmp")
    os.makedirs(tmp_path / "step_00000011")  # no manifest: incomplete
    assert tck.latest_step(str(tmp_path)) == 3
    assert tck.latest_step(str(tmp_path / "absent")) is None


def test_missing_leaf_and_shape_mismatch_raise(tmp_path):
    tree = _tree()
    tck.save_checkpoint(str(tmp_path), 1, tree)
    with pytest.raises(KeyError, match="missing leaf 'c'"):
        tck.restore_checkpoint(str(tmp_path), 1, {**tree, "c": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape mismatch for a"):
        tck.restore_checkpoint(str(tmp_path), 1, {**tree, "a": torch.zeros(6)})


def test_async_snapshots_before_returning_and_keeps_the_last_steps(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path), keep=2)
    tree = _tree()
    want = tree["a"].clone()
    for step in (1, 2, 3):
        ck.save(step, tree)
        tree["a"].add_(1.0)  # the training loop writes in place right after save
        want_step = want + (step - 1)
        ck.wait()
        assert torch.equal(tck.restore_checkpoint(str(tmp_path), step, tree)["a"], want_step)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000003"]


@pytest.fixture(scope="module")
def bf16_states():
    """The reference's tiny-model train state in bfloat16 after one AdamW step
    (moments nonzero, count 1)."""
    from repro.optim import adamw_update as jadamw

    jcfg, tcfg = (dataclasses.replace(c, dtype="bfloat16") for c in lt.configs())
    opt = JAdamW()
    jst = jstate.init_train_state(jcfg, opt, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda p: jnp.full(p.shape, 0.01, p.dtype), jst["params"])
    params, o, _ = jadamw(opt, jst["params"], grads, jst["opt"])
    jst = {"params": params, "opt": o, "step": jnp.asarray(1, jnp.int32)}
    return jcfg, tcfg, jst


def _flat(tree) -> dict:
    out = {}
    for path, leaf in tu.tree_flatten_with_path(tree)[0]:
        t = torch.stack(leaf.parts) if isinstance(leaf, tu.Stacked) else leaf
        out[tu.path_str(path)] = t.detach().to(torch.float32).numpy()
    return out


def _jflat(tree) -> dict:
    return {"/".join(str(k.key) for k in path): np.asarray(jnp.asarray(v).astype(jnp.float32))
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_reference_checkpoint_restores_in_the_port_bitwise(tmp_path, bf16_states):
    jcfg, tcfg, jst = bf16_states
    jck.save_checkpoint(str(tmp_path), 1, jst)
    like = tstate.checkpoint_tree(tstate.train_state_shapes(tcfg, TAdamW()))
    st = tstate.state_from_tree(tcfg, tck.restore_checkpoint(str(tmp_path), 1, like), device="cpu")
    assert next(st["params"].parameters()).dtype == torch.bfloat16
    assert all(p.requires_grad for p in st["params"].parameters())
    got, want = _flat(tstate.checkpoint_tree(st)), _jflat(jst)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_port_checkpoint_restores_in_the_reference_bitwise(tmp_path, bf16_states):
    jcfg, tcfg, jst = bf16_states
    jck.save_checkpoint(str(tmp_path / "ref"), 1, jst)
    like = tstate.checkpoint_tree(tstate.train_state_shapes(tcfg, TAdamW()))
    st = tstate.state_from_tree(tcfg, tck.restore_checkpoint(str(tmp_path / "ref"), 1, like), device="cpu")
    tck.save_checkpoint(str(tmp_path / "port"), 1, tstate.checkpoint_tree(st))
    back = jck.restore_checkpoint(str(tmp_path / "port"), 1, jstate.train_state_shapes(jcfg, JAdamW()))
    got, want = _jflat(back), _jflat(jst)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert jax.tree_util.tree_leaves(back)[0].dtype == jnp.int32
    manifests = [json.load(open(tmp_path / d / "step_00000001" / "manifest.json")) for d in ("ref", "port")]
    assert manifests[0] == manifests[1]
    for e in manifests[0]["leaves"]:
        assert open(tmp_path / "ref" / "step_00000001" / e["file"], "rb").read() == \
            open(tmp_path / "port" / "step_00000001" / e["file"], "rb").read(), e["path"]


def test_reference_hybrid_weights_restore_in_the_port_bitwise(tmp_path):
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro_torch.configs import get_config as tget
    from repro_torch.models import lm as tlm

    jc = dataclasses.replace(jget("hymba-1.5b").reduced(), dtype="bfloat16")
    tc = dataclasses.replace(tget("hymba-1.5b").reduced(), dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    jck.save_checkpoint(str(tmp_path), 2, jp)
    back = tck.restore_checkpoint(str(tmp_path), 2, tu.stacked_tree(tlm.meta_params(tc).state_dict()))
    got, want = _flat(back), _jflat(jp)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dtypes = {tu.path_str(p): leaf.dtype for p, leaf in tu.tree_flatten_with_path(back)[0]}
    assert dtypes.pop("layers/mamba/A_log") == torch.float32
    assert set(dtypes.values()) == {torch.bfloat16}
    model = tlm.params_from_named(tc, tu.unstack_tree(back)).state_dict()
    ref = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu").state_dict()
    assert model.keys() == ref.keys()
    for k, t in ref.items():
        assert model[k].dtype == t.dtype and torch.equal(model[k], t), k


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_reference_encdec_and_vlm_weights_restore_in_the_port_bitwise(tmp_path, arch):
    """A reference checkpoint of a reduced bf16 tree (whisper's encoder stacked
    under ``enc_layers``, its cross blocks under ``layers``; pixtral's
    ``vit_proj``) restores bitwise onto the port's stacked tree, at the
    reference's paths in its leaf order, and gives the model
    ``params_from_reference`` gives."""
    from repro.configs import get_config as jget
    from repro.models import lm as jlm
    from repro_torch.configs import get_config as tget
    from repro_torch.models import lm as tlm

    jc = dataclasses.replace(jget(arch).reduced(), dtype="bfloat16")
    tc = dataclasses.replace(tget(arch).reduced(), dtype="bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    jck.save_checkpoint(str(tmp_path), 2, jp)
    like = tu.stacked_tree(tlm.meta_params(tc).state_dict())
    assert [tu.path_str(p) for p, _ in tu.tree_flatten_with_path(like)[0]] == \
        ["/".join(str(k.key) for k in p) for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]]
    back = tck.restore_checkpoint(str(tmp_path), 2, like)
    got, want = _flat(back), _jflat(jp)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    dtypes = {tu.path_str(p): leaf.dtype for p, leaf in tu.tree_flatten_with_path(back)[0]}
    assert set(dtypes.values()) == {torch.bfloat16}
    assert ("enc_layers/attn/wq" in dtypes, "vit_proj/w" in dtypes) == (tc.encdec, tc.vlm)
    model = tlm.params_from_named(tc, tu.unstack_tree(back)).state_dict()
    ref = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu").state_dict()
    assert model.keys() == ref.keys()
    for k, t in ref.items():
        assert model[k].dtype == t.dtype and torch.equal(model[k], t), k
