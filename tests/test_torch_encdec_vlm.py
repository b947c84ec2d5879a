"""The port's encoder-decoder and VLM pieces against the JAX reference (CPU).

``attention.gqa_forward`` bidirectional (``causal=False``) and as cross
attention (``kv_source``), and ``cross_decode`` at G = H/KV = 1 and 2, within
``LAYER_TOL`` of the reference (float32, relative to the largest reference
value). Neither rotates anything: the keys and values ``return_kv`` gives are
the plain projections, and permuting the source's positions permutes the
bidirectional output and leaves the cross output as it is. ``encoder_forward``
of the reduced whisper-small (2 layers over 16 frames, 4 heads on 2 kv heads)
and ``embed_inputs`` (x, loss mask and enc_out; pixtral's patches in the first P
positions with their mask zeroed, whisper's frames through the encoder) within
``MODEL_TOL``. ``init_params`` of both reduced configs bitwise the reference's,
float32 and bfloat16; at vit_dim 32 pixtral's ``vit_proj`` (normal / √32, a
division) differs from the product by 1/√32 on many entries, so the test
sees which one was drawn. A prompt rectangle shorter than the patches raises
``ValueError``; the decode reads the cross keys and values from the cache and
neither writes them nor projects them again; bfloat16 forwards of both within
``BF16_TOL``. The reference's outputs are computed once per shape (module-scoped
fixtures).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn, lm as jlm
from repro_torch.configs import get_config as tget
from repro_torch.models import attention as tattn, lm as tlm
from repro_torch.utils import prng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

LAYER_TOL = 2e-6
MODEL_TOL = 1e-5
BF16_TOL = 3e-2
CPU = "cpu"
D, HD, S, SK = 32, 8, 11, 13  # model width, head dim, query positions, source positions


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _gqa_weights(heads, kv, seed):
    rs = np.random.default_rng(seed)
    w = {n: (rs.standard_normal(s) / 6).astype(np.float32) for n, s in
         (("wq", (D, heads * HD)), ("wk", (D, kv * HD)), ("wv", (D, kv * HD)), ("wo", (heads * HD, D)))}
    return {k: jnp.asarray(v) for k, v in w.items()}, tattn.GQA(*(_t(w[n]) for n in ("wq", "wk", "wv", "wo")))


# ------------------------------------------------------------------ attention


@pytest.fixture(scope="module", params=[(4, 4), (4, 2)], ids=["G1", "G2"])
def gqa_case(request):
    """Weights, inputs and the reference's bidirectional and cross outputs (with
    their k, v) for one head grouping."""
    heads, kv = request.param
    jp, tp = _gqa_weights(heads, kv, 20 + kv)
    rs = np.random.default_rng(30 + kv)
    x = rs.standard_normal((2, S, D)).astype(np.float32)
    src = rs.standard_normal((2, SK, D)).astype(np.float32)
    args = dict(heads=heads, kv_heads=kv, head_dim=HD, rope_theta=1e4, chunk=4)
    want = {
        "bidirectional": jattn.gqa_forward(jp, jnp.asarray(x), causal=False, return_kv=True, **args),
        "cross": jattn.gqa_forward(jp, jnp.asarray(x), causal=False, kv_source=jnp.asarray(src), return_kv=True,
                                   **args),
    }
    return dict(jp=jp, tp=tp, x=x, src=src, args=args, want=want, heads=heads, kv=kv)


@pytest.mark.parametrize("mode", ["bidirectional", "cross"])
def test_gqa_forward_bidirectional_and_cross_match_the_reference(gqa_case, mode):
    c = gqa_case
    source = {} if mode == "bidirectional" else {"kv_source": _t(c["src"])}
    out, (k, v) = tattn.gqa_forward(c["tp"], _t(c["x"]), causal=False, return_kv=True, **source, **c["args"])
    jo, (jk, jv) = c["want"][mode]
    assert max(_rel(out, jo), _rel(k, jk), _rel(v, jv)) <= LAYER_TOL
    # Unrotated: the keys and values are the source's plain projections.
    src = _t(c["x"] if mode == "bidirectional" else c["src"])
    assert torch.equal(k, (src @ c["tp"].wk).reshape(k.shape)) and torch.equal(v, (src @ c["tp"].wv).reshape(v.shape))


@pytest.mark.parametrize("mode", ["bidirectional", "cross"])
def test_gqa_forward_without_rotary_ignores_source_order(gqa_case, mode):
    """No positions: permuting the source permutes a bidirectional output and
    leaves a cross output as it is (within LAYER_TOL: other summation orders)."""
    c = gqa_case
    x, src = _t(c["x"]), _t(c["src"])
    perm = torch.from_numpy(np.random.default_rng(5).permutation(SK if mode == "cross" else S))
    if mode == "cross":
        a = tattn.gqa_forward(c["tp"], x, causal=False, kv_source=src, **c["args"])
        b = tattn.gqa_forward(c["tp"], x, causal=False, kv_source=src[:, perm], **c["args"])
    else:
        a = tattn.gqa_forward(c["tp"], x, causal=False, **c["args"])[:, perm]
        b = tattn.gqa_forward(c["tp"], x[:, perm], causal=False, **c["args"])
    assert _rel(b, a) <= LAYER_TOL


def test_cross_decode_matches_the_reference(gqa_case):
    c = gqa_case
    rs = np.random.default_rng(40 + c["kv"])
    xd = rs.standard_normal((2, 1, D)).astype(np.float32)
    xk = rs.standard_normal((2, SK, c["kv"], HD)).astype(np.float32)
    xv = rs.standard_normal((2, SK, c["kv"], HD)).astype(np.float32)
    shape = dict(heads=c["heads"], kv_heads=c["kv"], head_dim=HD)
    want = jattn.cross_decode(c["jp"], jnp.asarray(xd), jnp.asarray(xk), jnp.asarray(xv), **shape)
    got = tattn.cross_decode(c["tp"], _t(xd), _t(xk), _t(xv), **shape)
    assert tuple(got.shape) == (2, 1, D) and _rel(got, want) <= LAYER_TOL
    # The one-token cross decode is the cross forward's row for that token.
    fwd = tattn.gqa_forward(c["tp"], _t(xd), causal=False, kv_source=_t(c["src"]), **c["args"])
    src = _t(c["src"])
    kc = (src @ c["tp"].wk).reshape(2, SK, c["kv"], HD)
    vc = (src @ c["tp"].wv).reshape(2, SK, c["kv"], HD)
    assert _rel(tattn.cross_decode(c["tp"], _t(xd), kc, vc, **shape), fwd) <= LAYER_TOL


# ------------------------------------------------------------------ the models


def _cfgs(arch, dtype="float32"):
    return (dataclasses.replace(jget(arch).reduced(), dtype=dtype),
            dataclasses.replace(tget(arch).reduced(), dtype=dtype))


@functools.lru_cache(maxsize=None)
def _model(arch):
    """The reduced model in both packages (the port's converted from the
    reference's tree), a batch with its frames or patches, and the reference's
    ``embed_inputs`` of it."""
    jc, tc = _cfgs(arch)
    jp = jlm.init_params(jc, jax.random.PRNGKey(2))
    tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device=CPU)
    rs = np.random.default_rng(50)
    toks = rs.integers(0, jc.vocab_size, (2, 9)).astype(np.int32)
    mask = (rs.random((2, 9)) < 0.7).astype(np.float32)
    jb = {"tokens": jnp.asarray(toks), "loss_mask": jnp.asarray(mask)}
    tb = {"tokens": _t(toks).long(), "loss_mask": _t(mask)}
    stub = "frames" if jc.encdec else "patches"
    shape = (2, jc.enc_seq, jc.d_model) if jc.encdec else (2, jc.num_image_tokens, jc.vit_dim)
    a = rs.standard_normal(shape).astype(np.float32)
    jb[stub], tb[stub] = jnp.asarray(a), _t(a)
    return dict(jc=jc, tc=tc, jp=jp, tp=tp, jb=jb, tb=tb, want=jlm.embed_inputs(jp, jc, jb))


@pytest.fixture(scope="module", params=["whisper-small", "pixtral-12b"])
def model(request):
    return _model(request.param)


@pytest.fixture(scope="module")
def whisper():
    return _model("whisper-small")


def test_embed_inputs_with_frames_or_patches_matches_the_reference(model):
    x, mask, enc_out = tlm.embed_inputs(model["tp"], model["tc"], model["tb"])
    jx, jmask, jenc = model["want"]
    assert _rel(x, jx) <= MODEL_TOL and np.array_equal(mask.numpy(), np.asarray(jmask))
    assert (enc_out is None) == (jenc is None) == (not model["tc"].encdec)
    if model["tc"].vlm:
        P = model["tc"].num_image_tokens
        assert not mask[:, :P].any() and torch.equal(mask[:, P:], model["tb"]["loss_mask"][:, P:])
        assert torch.equal(x[:, P:], model["tp"].embed(model["tb"]["tokens"][:, P:]))
    else:
        assert tuple(enc_out.shape) == (2, model["tc"].enc_seq, model["tc"].d_model)
        assert _rel(enc_out, jenc) <= MODEL_TOL


def test_encoder_forward_matches_the_reference(whisper):
    model = whisper
    frames = model["tb"]["frames"]
    want = jlm.encoder_forward(model["jp"], model["jc"], jnp.asarray(frames.numpy()))
    got = tlm.encoder_forward(model["tp"], model["tc"], frames)
    assert got.dtype == torch.float32 and _rel(got, want) <= MODEL_TOL
    # Bidirectional and without positions: permuted frames give the permuted output.
    perm = torch.from_numpy(np.random.default_rng(6).permutation(frames.shape[1]))
    assert _rel(tlm.encoder_forward(model["tp"], model["tc"], frames[:, perm]), got[:, perm]) <= MODEL_TOL


def test_a_rectangle_shorter_than_the_patches_is_refused():
    _, tc = _cfgs("pixtral-12b")
    tp = tlm.init_params(tc, prng.prng_key(0), device=CPU)
    P = tc.num_image_tokens
    batch = {"tokens": torch.zeros((2, P - 1), dtype=torch.int64), "patches": torch.zeros((2, P, tc.vit_dim))}
    with pytest.raises(ValueError, match=f"{P} patches do not fit a prompt of {P - 1} positions"):
        tlm.embed_inputs(tp, tc, batch)
    x, mask, _ = tlm.embed_inputs(tp, tc, dict(batch, tokens=torch.zeros((2, P), dtype=torch.int64)))
    assert tuple(x.shape) == (2, P, tc.d_model) and not mask.any()  # P positions, all patches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_init_params_of_the_reduced_configs_is_bitwise_the_reference(arch, dtype):
    jc, tc = _cfgs(arch, dtype)
    jp = jlm.init_params(jc, jax.random.PRNGKey(3))
    sd = tlm.init_params(tc, prng.prng_key(3), device=CPU).state_dict()
    n = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = [p.key for p in path]
        a = np.asarray(leaf.astype(jnp.float32))
        pairs = ([(f"{names[0]}.{l}." + ".".join(names[1:]), a[l]) for l in range(a.shape[0])]
                 if names[0] in ("layers", "enc_layers") else [(".".join(names), a)])
        for name, want in pairs:
            assert np.array_equal(sd[name].to(torch.float32).numpy(), want), name
            n += 1
    assert n == len(sd)
    if tc.vlm:
        # The divided draw is not the product by the rounded reciprocal: at vit_dim 32
        # the two part on many entries, so the equality above held the division.
        k_vit = prng.split(prng.prng_key(3), 6)[5]
        z = prng.normal(k_vit, (tc.vit_dim, tc.d_model))
        product = (z * (1.0 / np.sqrt(tc.vit_dim))).to(tlm.torch_dtype(tc))
        assert torch.equal(sd["vit_proj.w"], (z / float(np.sqrt(tc.vit_dim))).to(tlm.torch_dtype(tc)))
        if dtype == "float32":
            assert int((product != sd["vit_proj.w"]).sum()) > 0.2 * product.numel()


def test_decode_reads_the_cross_cache_and_never_writes_or_projects_it(whisper):
    """Three decode steps after the batched prefill: the cross cache is the same
    tensor with the same values, and the logits are the same with the cross
    ``wk`` and ``wv`` set to NaN (the decode does not project the frames again)."""
    tc, tp, tb = whisper["tc"], whisper["tp"], whisper["tb"]
    _, cache = tlm.batched_prefill(tp, tc, tb, cache_len=16)
    xk, xv = cache["xk"], cache["xv"]
    xk0, xv0 = xk.clone(), xv.clone()
    poisoned = tlm.params_from_named(tc, {k: t.clone() for k, t in tp.state_dict().items()})
    for layer in poisoned.layers:
        layer.xattn.wk.fill_(float("nan"))
        layer.xattn.wv.fill_(float("nan"))
    twin = {k: t.clone() for k, t in cache.items()}
    tok = tb["tokens"][:, -1]
    for pos in range(9, 12):
        a, cache = tlm.decode_step(tp, tc, tok, cache, pos)
        b, twin = tlm.decode_step(poisoned, tc, tok, twin, pos)
        assert torch.equal(a, b) and bool(torch.isfinite(a).all())
        tok = torch.argmax(a, dim=-1)
    assert cache["xk"] is xk and cache["xv"] is xv
    assert torch.equal(xk, xk0) and torch.equal(xv, xv0)


@pytest.mark.parametrize("arch", ["whisper-small", "pixtral-12b"])
def test_bfloat16_encdec_and_vlm_forward_matches_the_reference(arch):
    jc, tc = _cfgs(arch, "bfloat16")
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device=CPU)
    rs = np.random.default_rng(12)
    toks = rs.integers(0, jc.vocab_size, (2, 20)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    stub = "frames" if jc.encdec else "patches"
    a = rs.standard_normal((2, jc.enc_seq, jc.d_model) if jc.encdec else (2, jc.num_image_tokens, jc.vit_dim))
    jb[stub], tb[stub] = jnp.asarray(a.astype(np.float32)), _t(a.astype(np.float32))
    assert tp.embed.table.dtype == torch.bfloat16
    assert _rel(tlm.forward_logits(tp, tc, tb), jlm.forward_logits(jp, jc, jb)) <= BF16_TOL
