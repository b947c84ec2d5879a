"""The port's MLA (``repro_torch.models.attention``'s MLA half) against the JAX
reference (CPU).

The same numpy inputs, made from a seed, go through ``repro.models.attention``
and the port, at minicpm3's reduced widths (4 heads, q_lora = kv_lora = 16,
nope = rope = 8, v = 16) and at a small copy of its full shape (q and k of 96
values, v of 64: the value width differs from the query's). ``init_mla`` is
bitwise the reference's in float32 and bfloat16. ``mla_forward`` with
``return_kv`` (the output, c_kv and the rotated k_rope) at S not a multiple of
the key chunk, and ``mla_decode`` over several positions continuing that latent
cache, within ``LAYER_TOL`` of the largest reference value (float32 sums of at
most a few hundred products in other orders); the decode's cache leaves are
the reference's. The decode is the absorbed form: no tensor it makes has a
per-head key or value axis over the cache's positions (recorded op by op).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import attention as jattn
from repro_torch.models import attention as tattn
from repro_torch.utils import prng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

LAYER_TOL = 2e-6
THETA = 1e4
# (d, heads, q_lora, kv_lora, nope, rope_d, v_dim): the reduced minicpm3, and its full shape cut in width
SHAPES = {"reduced": (64, 4, 16, 16, 8, 8, 16), "full_heads": (96, 3, 24, 32, 64, 32, 64)}
S, STEPS, SC = 21, 4, 28  # prompt, decode steps, cache length


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _params(shape: str, dtype: str = "float32", seed: int = 2):
    d, H, ql, r, nope, rope_d, v = SHAPES[shape]
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    args = dict(q_lora=ql, kv_lora=r, nope=nope, rope_d=rope_d, v_dim=v)
    jp = jattn.init_mla(jax.random.PRNGKey(seed), d, H, dtype=jdt, **args)
    tp = tattn.init_mla(prng.prng_key(seed), d, H, dtype=tdt, device="cpu", **args)
    return jp, tp


def _args(shape: str) -> dict:
    d, H, ql, r, nope, rope_d, v = SHAPES[shape]
    return dict(heads=H, kv_lora=r, nope=nope, rope_d=rope_d, v_dim=v)


@pytest.fixture(scope="module")
def reference():
    """The reference's prefill of S tokens (chunk 8) with its latent cache, then
    STEPS decode steps on a cache of SC positions, once for each shape."""
    out = {}
    for shape in SHAPES:
        jp, tp = _params(shape)
        d, H, ql = SHAPES[shape][:3]
        x = np.random.default_rng(len(shape)).standard_normal((2, S + STEPS, d)).astype(np.float32)
        a = _args(shape)
        y, (ckv, krope) = jattn.mla_forward(jp, jnp.asarray(x[:, :S]), q_lora=ql, rope_theta=THETA, chunk=8,
                                            return_kv=True, **a)
        cc = jnp.zeros((2, SC, a["kv_lora"])).at[:, :S].set(ckv)
        ck = jnp.zeros((2, SC, a["rope_d"])).at[:, :S].set(krope)
        steps = []
        for pos in range(S, S + STEPS):
            o, cc, ck = jattn.mla_decode(jp, jnp.asarray(x[:, pos : pos + 1]), cc, ck, jnp.int32(pos),
                                         rope_theta=THETA, **a)
            steps.append(np.asarray(o))
        out[shape] = dict(tp=tp, x=x, y=np.asarray(y), ckv=np.asarray(ckv), krope=np.asarray(krope), steps=steps,
                          cache=(np.asarray(cc), np.asarray(ck)))
    return out


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_init_mla_is_the_reference_init(shape, dtype, seed):
    jp, tp = _params(shape, dtype, seed)
    sd = tp.state_dict()
    assert set(sd) == set(jp)
    for name, want in jp.items():
        assert sd[name].dtype == (torch.float32 if dtype == "float32" else torch.bfloat16)
        assert np.array_equal(sd[name].to(torch.float32).numpy(), np.asarray(want.astype(jnp.float32))), name


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_forward_with_latent_cache_matches_the_reference(reference, shape):
    r = reference[shape]
    y, (ckv, krope) = tattn.mla_forward(r["tp"], _t(r["x"][:, :S]), rope_theta=THETA, chunk=8, return_kv=True,
                                        **_args(shape))
    assert tuple(ckv.shape) == r["ckv"].shape and tuple(krope.shape) == r["krope"].shape
    assert _rel(y, r["y"]) <= LAYER_TOL
    assert _rel(ckv, r["ckv"]) <= LAYER_TOL and _rel(krope, r["krope"]) <= LAYER_TOL


def _decode_steps(r, shape, record=None):
    """The port's decode over STEPS positions from the reference's own latent
    cache of the prompt; returns (outputs, ckv cache, krope cache)."""
    a = _args(shape)
    cc = torch.zeros((2, SC, a["kv_lora"]))
    ck = torch.zeros((2, SC, a["rope_d"]))
    cc[:, :S], ck[:, :S] = _t(r["ckv"]), _t(r["krope"])
    outs = []
    for pos in range(S, S + STEPS):
        tables = tattn.decode_tables(pos, SC, a["rope_d"], THETA, "cpu")
        x = _t(r["x"][:, pos : pos + 1])
        if record is None:
            outs.append(tattn.mla_decode(r["tp"], x, cc, ck, tables, **a))
        else:
            with record:
                outs.append(tattn.mla_decode(r["tp"], x, cc, ck, tables, **a))
    return outs, cc, ck


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_decode_over_several_positions_matches_the_reference(reference, shape):
    r = reference[shape]
    outs, cc, ck = _decode_steps(r, shape)
    for got, want in zip(outs, r["steps"]):
        assert tuple(got.shape) == want.shape and _rel(got, want) <= LAYER_TOL
    assert _rel(cc, r["cache"][0]) <= LAYER_TOL and _rel(ck, r["cache"][1]) <= LAYER_TOL


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.shapes.append(tuple(t.shape))
        return out


@pytest.mark.parametrize("shape", list(SHAPES))
def test_mla_decode_is_absorbed_and_never_expands_the_cache(reference, shape):
    """No op of the decode returns a tensor with both the cache's SC positions
    and the heads or a per-head key or value width: scores (B, H, SC) and the
    latent cache's float32 copies (B, SC, kv_lora) are the largest it makes."""
    r = reference[shape]
    a = _args(shape)
    rec = _Shapes()
    _decode_steps(r, shape, rec)
    big = [s for s in rec.shapes if SC in s and math.prod(s) > 2 * SC * max(a["heads"], a["kv_lora"])]
    assert not big, big
    assert (2, a["heads"], SC) in rec.shapes  # the absorbed scores
