"""The port's decoder LM against the JAX reference (CPU, reduced configs).

Configs: every field of granite-3-8b, chatglm3-6b, mixtral-8x7b, gemma3-12b,
grok-1-314b, minicpm3-4b, hymba-1.5b, whisper-small, pixtral-12b and
falcon-mamba-7b, full and
``reduced()``, and the shape specs, equal the reference's (reduced: mixtral 2
layers and 4 experts, gemma3 6 layers, one full local:global period, grok 2
layers, windows 8; minicpm3's MLA at q_lora = kv_lora = 16, nope = rope = 8, v
= 16; hymba's and falcon's Mamba at d_inner 128, state 8, dt_rank 8 (falcon 2
layers of it alone); whisper 2 encoder and
2 decoder layers over 16 frames, 4 heads on 2 kv heads; pixtral 4 patches of
vit_dim 32). Layers (float32): ``rmsnorm``,
``rope_angles``, ``apply_rope`` (fraction 1.0 and 0.5), ``swiglu``, ``embed``,
``cross_entropy_loss`` and ``chunked_attention`` (S not a multiple of the chunk,
causal or not, windowed, G = 1 and 2) within ``LAYER_TOL`` of the reference's,
relative to the largest reference value: float32 sums of at most 64 products in
other orders, and torch's exp/cos/sin against XLA's, a few ulps each.

``init_params``: bitwise the reference's (``prng.normal`` is jax's normal bit for
bit), float32 and bfloat16 (a Mamba block's ``A_log`` float32 in both; the
encoder's stack and pixtral's divided ``vit_proj`` included), at two keys.

The model (parameters converted from the reference's tree, so the parity does
not rest on the init): ``forward_logits``, ``batched_prefill`` (logits and
cache), the token-by-token ``prefill`` and decode continuations, every arch in
float32 within ``MODEL_TOL`` of the largest reference logit (float32 through
two to six layers, sums in other orders; the Mamba scan's doubling associates
in another order than jax's ``associative_scan``), the MoE archs at their config's
capacity (assignments dropped), the caches leaf by leaf (the SWA ring, gemma3's
local rings and global caches, MLA's latent ``ckv`` and ``krope``, the Mamba
``conv`` and ``ssm`` states, hymba's ring beside them; prompts past the window,
so the rings wrap, and caches shorter than the window); hymba and falcon also
at a scan chunk of 8, so the prompts span several chunks and the last is padded;
``lm_loss`` with its MoE aux loss; whisper fed frames (the cross ``xk`` and
``xv`` leaf by leaf) and pixtral patches (its prompts at least as long as the
patches) throughout. bfloat16
forwards within ``BF16_TOL``: an activation's bfloat16 rounding (2⁻⁹ relative)
flips where the two float32 values before it differ by an ulp, and the layers
carry such flips to the logits. The bfloat16 MoE layer: where the reference's
router margin p_k − p_(k+1) exceeds 2 bfloat16 ulps of p_k the expert ids are
equal and those tokens' outputs within ``BF16_TOL``; the tokens under the margin
are counted and bounded. The port's own forward = batched prefill = token
prefill = decode (MoE at dropless capacity, as ``tests/test_decode_consistency.py``
holds the reference). Tokens (``lm_batch``, ``lm_eval_batch``) are bitwise the
reference's; every config the reference registers is accepted (the MLA,
hybrid, encoder-decoder, VLM and attention-free ones also with their reduced
models and caches), and a family the config system does not name raises
``ValueError``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase, get_config as jget
from repro.data import tokens as jtok
from repro.models import attention as jattn, layers as jlayers, lm as jlm
from repro_torch.configs import base as tbase, get_config as tget
from repro_torch.data import tokens as ttok
from repro_torch.models import attention as tattn, layers as tlayers, lm as tlm
from repro_torch.utils import prng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

ARCHS = ["granite-3-8b", "chatglm3-6b", "mixtral-8x7b", "gemma3-12b", "grok-1-314b", "minicpm3-4b", "hymba-1.5b",
         "whisper-small", "pixtral-12b", "falcon-mamba-7b"]
WINDOWED = ["mixtral-8x7b", "gemma3-12b", "hymba-1.5b"]
MLA_HYBRID = ["minicpm3-4b", "hymba-1.5b"]
ENCDEC_VLM = ["whisper-small", "pixtral-12b"]
STACKS = ("layers", "enc_layers")
LAYER_TOL = 2e-6
MODEL_TOL = 1e-5
BF16_TOL = 3e-2
CPU = "cpu"


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rs(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------------------ configs


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_match_the_reference(arch):
    for j, t in ((jget(arch), tget(arch)), (jget(arch).reduced(), tget(arch).reduced())):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.padded_vocab, j.resolved_head_dim, j.param_count()) == (t.padded_vocab, t.resolved_head_dim,
                                                                          t.param_count())
    assert arch in tbase.list_archs()


def test_shapes_and_applicability_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tbase.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in ARCHS:
        for name in jbase.SHAPES:
            assert tbase.shape_applicable(tget(arch), tbase.SHAPES[name]) == jbase.shape_applicable(
                jget(arch), jbase.SHAPES[name])
    with pytest.raises(KeyError, match="unknown arch"):
        tget("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_the_reference_at_full_size(arch):
    """Every state-dict leaf against the reference's tree leaf of its path (a
    layer leaf without its leading L), its dtype (``A_log`` float32 in a
    bfloat16 model), the leaves a layer and the total."""
    want = jlm.param_shapes(jget(arch))
    got = tlm.meta_params(tget(arch)).state_dict()
    assert tlm.param_shapes(tget(arch)) == {k: t.shape for k, t in got.items()}
    per_layer = 0
    for name, t in got.items():
        parts = name.split(".")
        node = want
        for p in parts[:1] + parts[2:] if parts[0] in STACKS else parts:
            node = node[p]
        shape = node.shape[1:] if parts[0] in STACKS else node.shape
        assert tuple(t.shape) == shape, name
        assert (t.dtype == torch.float32) == (node.dtype == jnp.float32), name
        per_layer += parts[:2] == ["layers", "0"]
    assert per_layer * jget(arch).num_layers == sum(1 for k in got if k.startswith("layers."))
    assert per_layer == len([p for p in jax.tree_util.tree_leaves(want["layers"])])
    assert sum(t.numel() for t in got.values()) == sum(np.prod(a.shape) for a in jax.tree_util.tree_leaves(want))


# ------------------------------------------------------------------ layers


def test_rmsnorm_matches():
    rs = _rs(0)
    x, scale = rs.standard_normal((3, 5, 64)).astype(np.float32), rs.standard_normal(64).astype(np.float32)
    want = jlayers.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    assert _rel(tlayers.rmsnorm(_t(scale), _t(x), 1e-6), want) <= LAYER_TOL


def test_rope_angles_match():
    pos = np.arange(0, 3000, 7)
    for dim, theta in ((16, 1e4), (8, 5e5)):
        jc, js = jlayers.rope_angles(jnp.asarray(pos), dim, theta)
        tc, ts = tlayers.rope_angles(_t(pos), dim, theta)
        # angles up to 3,000 rad: one float32 ulp of the angle is ~2e-4 of its cos
        assert _rel(tc, jc) <= 5e-4 and _rel(ts, js) <= 5e-4


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_apply_rope_matches(fraction):
    rs = _rs(1)
    x = rs.standard_normal((2, 9, 4, 16)).astype(np.float32)
    rot = int(16 * fraction) & ~1
    jc, js = jlayers.rope_angles(jnp.arange(9), rot, 1e4)
    want = jlayers.apply_rope(jnp.asarray(x), jc[None], js[None], fraction)
    got = tlayers.apply_rope(_t(x), _t(jc)[None], _t(js)[None], fraction)
    assert _rel(got, want) <= LAYER_TOL
    if fraction < 1.0:
        assert torch.equal(got[..., rot:], _t(x)[..., rot:])  # the second half passes through


def test_swiglu_embed_unembed_match():
    rs = _rs(2)
    x = rs.standard_normal((2, 7, 64)).astype(np.float32)
    w = {n: (rs.standard_normal(s) / 8).astype(np.float32) for n, s in
         (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64)))}
    want = jlayers.swiglu({k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    assert _rel(tlayers.swiglu(_t(w["w_gate"]), _t(w["w_up"]), _t(w["w_down"]), _t(x)), want) <= LAYER_TOL
    table = rs.standard_normal((50, 64)).astype(np.float32)
    toks = rs.integers(0, 50, (3, 11))
    assert np.array_equal(tlayers.embed(_t(table), _t(toks)).numpy(),
                          np.asarray(jlayers.embed({"table": jnp.asarray(table)}, jnp.asarray(toks))))
    assert _rel(tlayers.unembed(_t(w["w_gate"]), _t(x)), jlayers.unembed({"w": jnp.asarray(w["w_gate"])},
                                                                          jnp.asarray(x))) <= LAYER_TOL


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_loss_matches(masked):
    rs = _rs(3)
    logits = (3 * rs.standard_normal((4, 9, 37))).astype(np.float32)
    labels = rs.integers(0, 37, (4, 9))
    mask = (rs.random((4, 9)) < 0.6).astype(np.float32) if masked else None
    want = jlayers.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels),
                                      None if mask is None else jnp.asarray(mask))
    got = tlayers.cross_entropy_loss(_t(logits), _t(labels), None if mask is None else _t(mask))
    assert abs(float(got) - float(want)) <= LAYER_TOL * abs(float(want))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("heads,kv", [(4, 4), (4, 2)])
def test_chunked_attention_matches(causal, window, heads, kv):
    rs = _rs(4 + heads + kv + window)
    B, S, hd, chunk = 2, 37, 16, 16  # 37 keys: three chunks, the last one padded
    q = rs.standard_normal((B, S, heads, hd)).astype(np.float32)
    k = rs.standard_normal((B, S, kv, hd)).astype(np.float32)
    v = rs.standard_normal((B, S, kv, hd)).astype(np.float32)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal, window=window,
                                   chunk=chunk)
    got = tattn.chunked_attention(_t(q), _t(k), _t(v), causal=causal, window=window, chunk=chunk)
    assert _rel(got, want) <= LAYER_TOL


def test_gqa_forward_and_decode_match():
    rs = _rs(5)
    d, H, KV, hd, S = 32, 4, 2, 8, 11
    w = {n: (rs.standard_normal(s) / 6).astype(np.float32) for n, s in
         (("wq", (d, H * hd)), ("wk", (d, KV * hd)), ("wv", (d, KV * hd)), ("wo", (H * hd, d)))}
    jp, tp = {k: jnp.asarray(v) for k, v in w.items()}, tattn.GQA(*(_t(w[n]) for n in ("wq", "wk", "wv", "wo")))
    x = rs.standard_normal((2, S, d)).astype(np.float32)
    args = dict(heads=H, kv_heads=KV, head_dim=hd, rope_fraction=0.5)
    jo, (jk, jv) = jattn.gqa_forward(jp, jnp.asarray(x), rope_theta=1e4, chunk=4, return_kv=True, **args)
    to, (tk, tv) = tattn.gqa_forward(tp, _t(x), rope_theta=1e4, chunk=4, return_kv=True, **args)
    assert max(_rel(to, jo), _rel(tk, jk), _rel(tv, jv)) <= LAYER_TOL
    # one decode step at position S against caches of S + 3 entries holding the prefix
    ck, cv = np.zeros((2, S + 3, KV, hd), np.float32), np.zeros((2, S + 3, KV, hd), np.float32)
    ck[:, :S], cv[:, :S] = np.asarray(jk), np.asarray(jv)
    xd = rs.standard_normal((2, 1, d)).astype(np.float32)
    jo, jck, _ = jattn.gqa_decode(jp, jnp.asarray(xd), jnp.asarray(ck), jnp.asarray(cv), jnp.int32(S),
                                  rope_theta=1e4, **args)
    tck, tcv = _t(ck.copy()), _t(cv.copy())
    tables = tattn.decode_tables(S, S + 3, int(hd * 0.5) & ~1, 1e4, torch.device(CPU))
    to = tattn.gqa_decode(tp, _t(xd), tck, tcv, tables, **args)
    assert _rel(to, jo) <= LAYER_TOL and _rel(tck, jck) <= LAYER_TOL


@pytest.mark.parametrize("pos", [3, 9, 14])
def test_ring_rule_matches_the_reference(pos):
    """Slot and valid entries of a ring of 6 (positions past it wrap)."""
    jslot, jvalid = jlm._ring_update_and_scores_mask(jnp.int32(pos), 6)
    _, _, slot, valid = tattn.decode_tables(pos, 6, 8, 1e4, torch.device(CPU))
    assert slot == int(jslot) and valid.tolist() == np.asarray(jvalid).tolist()


# ------------------------------------------------------------------ init


def _reference_leaves(jp, cfg):
    """(name, numpy array) for each port state-dict leaf of the reference tree."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]:
        names = [p.key for p in path]
        a = np.asarray(leaf.astype(jnp.float32))
        if names[0] in STACKS:
            for l in range(cfg.num_layers if names[0] == "layers" else cfg.enc_layers):
                yield f"{names[0]}.{l}." + ".".join(names[1:]), a[l]
        else:
            yield ".".join(names), a


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_is_the_reference_init(arch, dtype, seed):
    jc = dataclasses.replace(jget(arch).reduced(), dtype=dtype)
    tc = dataclasses.replace(tget(arch).reduced(), dtype=dtype)
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    sd = tlm.init_params(tc, prng.prng_key(seed), device=CPU).state_dict()
    seen = set()
    for name, want in _reference_leaves(jp, jc):
        seen.add(name)
        assert sd[name].dtype == tlm.leaf_dtype(name, tlm.torch_dtype(tc))
        assert np.array_equal(sd[name].to(torch.float32).numpy(), want), name
    assert seen == set(sd)


# ------------------------------------------------------------------ the model


def _models(arch, dtype="float32", seed=0, **changes):
    jc = dataclasses.replace(jget(arch).reduced(), dtype=dtype, **changes)
    tc = dataclasses.replace(tget(arch).reduced(), dtype=dtype, **changes)
    jp = jlm.init_params(jc, jax.random.PRNGKey(seed))
    tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device=CPU)
    return jc, tc, jp, tp


def _batch(vocab, B, S, seed, cfg=None):
    """Tokens, and with an encoder-decoder ``cfg`` its frames (B, enc_seq, d), with
    a VLM's its patches (B, P, vit_dim), N(0, 1) from the seed."""
    rs = _rs(seed)
    toks = rs.integers(0, vocab, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks).long()}
    if cfg is not None and cfg.encdec:
        frames = rs.standard_normal((B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
        jb["frames"], tb["frames"] = jnp.asarray(frames), _t(frames)
    if cfg is not None and cfg.vlm:
        patches = rs.standard_normal((B, cfg.num_image_tokens, cfg.vit_dim)).astype(np.float32)
        jb["patches"], tb["patches"] = jnp.asarray(patches), _t(patches)
    return jb, tb


def _assert_caches_match(got: dict, want) -> None:
    """The port's cache leaf by leaf against the reference's: the same keys and
    shapes (the local/global split included), values within MODEL_TOL."""
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    names = {".".join(p.key for p in path) for path, _ in leaves}
    flat = {f"{a}.{b}": t for a, sub in got.items() if isinstance(sub, dict) for b, t in sub.items()}
    flat.update({a: t for a, t in got.items() if not isinstance(t, dict)})
    assert set(flat) == names
    for path, leaf in leaves:
        t = flat[".".join(p.key for p in path)]
        assert tuple(t.shape) == leaf.shape and t.dtype == torch.float32
        assert _rel(t, leaf) <= MODEL_TOL, path


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_prefill_decode_match_the_reference(arch):
    jc, tc, jp, tp = _models(arch)
    B, S = 2, 21  # past the reduced window of 8: the rings wrap
    jb, tb = _batch(jc.vocab_size, B, S, 11, jc)
    assert _rel(tlm.forward_logits(tp, tc, tb), jlm.forward_logits(jp, jc, jb)) <= MODEL_TOL
    jl, jcache = jlm.batched_prefill(jp, jc, jb, cache_len=S + 4)
    tl, tcache = tlm.batched_prefill(tp, tc, tb, cache_len=S + 4)
    assert _rel(tl, jl) <= MODEL_TOL
    _assert_caches_match(tcache, jcache)
    jl2, jc2 = jlm.prefill(jp, jc, jb, jlm.init_cache(jc, B, S + 4))
    tl2, tc2 = tlm.prefill(tp, tc, tb, tlm.init_cache(tc, B, S + 4, device=CPU))
    assert _rel(tl2, jl2) <= MODEL_TOL
    _assert_caches_match(tc2, jc2)
    # three decode steps continuing the batched prefill's cache, the same tokens fed to both
    for step in range(3):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(tok), jcache, jnp.int32(S + step))
        tl, tcache = tlm.decode_step(tp, tc, _t(tok).long(), tcache, S + step)
        assert _rel(tl, jl) <= MODEL_TOL
    _assert_caches_match(tcache, jcache)


@pytest.mark.parametrize("S,cache_len", [(5, 6), (8, 12), (12, 8), (19, 24)])
@pytest.mark.parametrize("arch", WINDOWED)
def test_ring_caches_match_the_reference(arch, S, cache_len):
    """Batched prefill into rings of min(8, cache_len): prompts shorter than the
    ring (and a ring shorter than the window), as long as the window, longer
    than the cache, and past twice the window; then decode steps while the
    cache lasts."""
    jc, tc, jp, tp = _models(arch, seed=3)
    jb, tb = _batch(jc.vocab_size, 2, S, 15)
    jl, jcache = jlm.batched_prefill(jp, jc, jb, cache_len=cache_len)
    tl, tcache = tlm.batched_prefill(tp, tc, tb, cache_len=cache_len)
    assert _rel(tl, jl) <= MODEL_TOL
    _assert_caches_match(tcache, jcache)
    for pos in range(S, min(S + 2, cache_len)):
        tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(tok), jcache, jnp.int32(pos))
        tl, tcache = tlm.decode_step(tp, tc, _t(tok).long(), tcache, pos)
        assert _rel(tl, jl) <= MODEL_TOL
    _assert_caches_match(tcache, jcache)


@pytest.mark.parametrize("S", [3, 8, 13, 30])
@pytest.mark.parametrize("s_cache", [4, 8])
def test_ring_place_is_the_reference(S, s_cache):
    src = _rs(S + s_cache).standard_normal((2, 3, S, 2, 4)).astype(np.float32)  # (L, B, S, KV, hd)
    want = np.asarray(jlm._ring_place(jnp.asarray(src), s_cache))
    got = torch.zeros((2, 3, s_cache, 2, 4))
    for l in range(2):
        tlm._ring_place(got[l], _t(src[l]))
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seq", [1, 7, 30])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_is_the_reference_layout(arch, seq):
    want = jlm.init_cache(jget(arch).reduced(), 2, seq)
    got = tlm.init_cache(tget(arch).reduced(), 2, seq, device=CPU)
    _assert_caches_match(got, want)
    layers_read = len(tlm.layer_caches(tget(arch).reduced(), got))
    assert layers_read == tget(arch).reduced().num_layers


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_with_aux_matches_the_reference(arch):
    jc, tc, jp, tp = _models(arch, seed=4)
    jb, tb = _batch(jc.vocab_size, 2, 19, 16, jc)
    mask = (_rs(17).random((2, 19)) < 0.8).astype(np.float32)
    jloss, jm = jlm.lm_loss(jp, jc, dict(jb, labels=jb["tokens"], loss_mask=jnp.asarray(mask)))
    tloss, tm = tlm.lm_loss(tp, tc, dict(tb, labels=tb["tokens"], loss_mask=_t(mask)),
                            plan=tlm.ExecPlan(loss_chunk=8))
    assert (float(jm["moe_aux"]) > 0) == tc.moe
    for got, want in ((tloss, jloss), (tm["ce"], jm["ce"]), (tm["moe_aux"], jm["moe_aux"])):
        assert abs(float(got) - float(want)) <= MODEL_TOL * max(abs(float(want)), 1.0)


def test_bfloat16_forward_matches_the_reference():
    jc, tc, jp, tp = _models("granite-3-8b", "bfloat16", seed=1)
    jb, tb = _batch(jc.vocab_size, 2, 16, 12)
    assert tp.embed.table.dtype == torch.bfloat16
    assert _rel(tlm.forward_logits(tp, tc, tb), jlm.forward_logits(jp, jc, jb)) <= BF16_TOL


def test_bfloat16_local_global_forward_matches_the_reference():
    jc, tc, jp, tp = _models("gemma3-12b", "bfloat16", seed=1)
    jb, tb = _batch(jc.vocab_size, 2, 20, 12)
    assert _rel(tlm.forward_logits(tp, tc, tb), jlm.forward_logits(jp, jc, jb)) <= BF16_TOL


# Share of tokens whose reference router margin is under 2 bfloat16 ulps, at most:
# the reduced configs' 4-expert softmax puts p_2 and p_3 near 1/4, and one ulp
# there is 2⁻⁹ (the run below has 7 of 512 tokens, 0.014, for each arch; the
# bound leaves room for other draws).
BF16_UNDER_MARGIN_MAX = 0.1


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "grok-1-314b"])
def test_bfloat16_moe_layer_matches_the_reference_past_the_router_margin(arch):
    """Each layer's MoE of the bfloat16 reduced model on the same bfloat16 input
    (4 groups of 64 tokens), at the config's capacity for the ids and dropless
    for the outputs (a flipped expert moves the capacity windows of the
    group's later tokens): the ids equal wherever the reference's margin p_k −
    p_(k+1) exceeds 2 ulps of p_k in bfloat16, those tokens' outputs within
    BF16_TOL of the largest, and the tokens under the margin counted and bounded."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    jc, tc, jp, tp = _models(arch, "bfloat16", seed=5)
    E, k = tc.num_experts, tc.top_k
    x = _rs(18).standard_normal((4, 64, tc.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jnp.bfloat16), _t(x).to(torch.bfloat16)
    under = 0
    for l in range(tc.num_layers):
        jmp = jax.tree_util.tree_map(lambda a: a[l], jp["layers"]["moe"])
        tmp = tp.layers[l].moe
        logits = np.asarray(jnp.einsum("gtd,de->gte", jx, jmp["router"]).astype(jnp.float32))
        probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), axis=-1))
        top = -np.sort(-probs, axis=-1)
        ulp = 2.0 ** (np.floor(np.log2(top[..., k - 1])) - 7)
        sure = (top[..., k - 1] - top[..., k]) > 2 * ulp  # (G, T)
        under += int((~sure).sum())
        _, want_ids, _ = jmoe._route(jmp, jx, E, k)
        _, ids, _ = tmoe.route(tmp, tx, E, k)
        assert np.array_equal(ids.numpy()[sure], np.asarray(want_ids)[sure])
        want, _ = jmoe.moe_forward(jmp, jx, num_experts=E, top_k=k, capacity_factor=float(E))
        got, _ = tmoe.moe_forward(tmp, tx, num_experts=E, top_k=k, capacity_factor=float(E))
        assert got.dtype == torch.bfloat16
        want = np.asarray(want.astype(jnp.float32))
        assert _rel(got.to(torch.float32).numpy()[sure], want[sure]) <= BF16_TOL
    share = under / (tc.num_layers * x.shape[0] * x.shape[1])
    print(f"{arch}: {under} tokens under the bfloat16 router margin ({share:.3f})")
    assert share <= BF16_UNDER_MARGIN_MAX


def test_prefill_cache_longer_than_its_length_keeps_the_last_positions():
    jc, tc, jp, tp = _models("granite-3-8b")
    jb, tb = _batch(jc.vocab_size, 1, 12, 13)
    _, jcache = jlm.batched_prefill(jp, jc, jb, cache_len=8)
    _, tcache = tlm.batched_prefill(tp, tc, tb, cache_len=8)
    assert _rel(tcache["k"], jcache["k"]) <= MODEL_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_port_forward_equals_prefills_and_decode(arch):
    """The port alone: forward == batched prefill == token prefill == decode (an
    MoE at dropless capacity: the groups are sequences in the forward, the batch
    in decode)."""
    cf = {"capacity_factor": float(jget(arch).reduced().num_experts)} if jget(arch).moe else {}
    _, tc, _, tp = _models(arch, seed=2, **cf)
    B, S = 2, 24
    _, tb = _batch(tc.vocab_size, B, S + 1, 14, tc)
    full = tlm.forward_logits(tp, tc, tb)
    head = dict(tb, tokens=tb["tokens"][:, :S])
    lb, cb = tlm.batched_prefill(tp, tc, head, cache_len=S + 4)
    lt, ct = tlm.prefill(tp, tc, head, tlm.init_cache(tc, B, S + 4, device=CPU))
    assert _rel(lb, full[:, S - 1]) <= MODEL_TOL and _rel(lt, full[:, S - 1]) <= MODEL_TOL
    l1, _ = tlm.decode_step(tp, tc, tb["tokens"][:, S], cb, S)
    l2, _ = tlm.decode_step(tp, tc, tb["tokens"][:, S], ct, S)
    assert _rel(l1, full[:, S]) <= MODEL_TOL and _rel(l2, l1) <= MODEL_TOL


# ------------------------------------------------------------------ tokens


@pytest.mark.parametrize("vocab,seq,batch,offset", [(256, 40, 3, 0), (49155, 64, 2, 5), (65024, 33, 2, 0),
                                                   (262144, 48, 2, 0)])
def test_lm_batch_is_bitwise_the_reference(vocab, seq, batch, offset):
    """Vocabularies past 68,530 make a·tok overflow int32 (262,144: gemma3's), which
    the reference's recurrence wraps."""
    want = jtok.lm_batch(5, 3, batch=batch, seq=seq, vocab=vocab, row_offset=offset)
    got = ttok.lm_batch(5, 3, batch=batch, seq=seq, vocab=vocab, row_offset=offset, device=CPU)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    assert np.array_equal(got["labels"].numpy(), np.asarray(want["labels"]))
    assert np.array_equal(got["loss_mask"].numpy(), np.asarray(want["loss_mask"]))


def test_lm_eval_batch_is_bitwise_the_reference():
    want = jtok.lm_eval_batch(1, 0, batch=2, seq=30, vocab=49155)
    got = ttok.lm_eval_batch(1, 0, batch=2, seq=30, vocab=49155, device=CPU)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


def test_lm_batch_p_pattern_is_the_reference():
    want = jtok.lm_batch(2, 1, batch=2, seq=50, vocab=97, p_pattern=0.3)
    got = ttok.lm_batch(2, 1, batch=2, seq=50, vocab=97, p_pattern=0.3, device=CPU)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))


# ------------------------------------------------------------------ refusals


@pytest.mark.parametrize("seq", [1, 7, 4096, 40_000])
@pytest.mark.parametrize("arch", jbase.list_archs())
def test_layer_windows_and_cache_lengths_match_the_reference(arch, seq):
    """Every reference config."""
    cfg = tbase.ArchConfig(**{f.name: getattr(jget(arch), f.name) for f in dataclasses.fields(tbase.ArchConfig)})
    assert np.array_equal(tlm.layer_windows(cfg).numpy(), np.asarray(jlm.layer_windows(jget(arch))))
    assert np.array_equal(tlm.cache_lengths(cfg, seq).numpy(), np.asarray(jlm.cache_lengths(jget(arch), seq)))


@pytest.mark.parametrize("arch", jbase.list_archs())
def test_every_reference_config_is_accepted(arch):
    """Every config the reference registers, its fields as they are: accepted, its
    reduced model built with the meta model's shapes and the reference's cache
    layout."""
    cfg = tbase.ArchConfig(**dataclasses.asdict(jget(arch)))
    tlm.check_supported(cfg)
    small = tbase.ArchConfig(**dataclasses.asdict(jget(arch).reduced()))
    sd = tlm.init_params(small, prng.prng_key(0), device=CPU).state_dict()
    assert {k: t.shape for k, t in sd.items()} == tlm.param_shapes(small)
    _assert_caches_match(tlm.init_cache(small, 1, 8, device=CPU), jlm.init_cache(jget(arch).reduced(), 1, 8))


def test_a_family_the_config_system_does_not_name_is_refused():
    cfg = dataclasses.replace(tget("granite-3-8b").reduced(), family="rnn")
    for call in (lambda: tlm.check_supported(cfg), lambda: tlm.init_params(cfg, prng.prng_key(0), device=CPU),
                 lambda: tlm.init_cache(cfg, 1, 8, device=CPU), lambda: tlm.param_shapes(cfg)):
        with pytest.raises(ValueError, match="family 'rnn'"):
            call()


@pytest.mark.parametrize("arch", MLA_HYBRID)
def test_mla_and_hybrid_configs_are_accepted(arch):
    """The reference's own config (its fields as they are) through the calls that
    refuse the families not ported: each gives the reference's shapes."""
    cfg = tbase.ArchConfig(**dataclasses.asdict(jget(arch).reduced()))
    tlm.check_supported(cfg)
    sd = tlm.init_params(cfg, prng.prng_key(0), device=CPU).state_dict()
    assert {k: t.shape for k, t in sd.items()} == tlm.param_shapes(cfg)
    _assert_caches_match(tlm.init_cache(cfg, 1, 8, device=CPU), jlm.init_cache(jget(arch).reduced(), 1, 8))


@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_encdec_and_vlm_configs_are_accepted(arch):
    """As for MLA and the hybrid: the reference's own config through the calls
    that refuse the families not ported, the cross caches among the leaves."""
    cfg = tbase.ArchConfig(**dataclasses.asdict(jget(arch).reduced()))
    tlm.check_supported(cfg)
    sd = tlm.init_params(cfg, prng.prng_key(0), device=CPU).state_dict()
    assert {k: t.shape for k, t in sd.items()} == tlm.param_shapes(cfg)
    assert ("enc_norm.scale" in sd, "vit_proj.w" in sd) == (cfg.encdec, cfg.vlm)
    _assert_caches_match(tlm.init_cache(cfg, 1, 8, device=CPU), jlm.init_cache(jget(arch).reduced(), 1, 8))


@pytest.mark.parametrize("S", [16, 21])
def test_hymba_across_scan_chunks_matches_the_reference(S):
    """ssm_chunk 8 in both packages: the prompt spans two or three chunks, the
    last one padded at S = 21; forward, batched prefill (logits and the conv
    and ssm states beside the ring) and a decode step after it."""
    _across_scan_chunks("hymba-1.5b", S)


@pytest.mark.parametrize("S", [16, 21])
def test_falcon_across_scan_chunks_matches_the_reference(S):
    """As for hymba, on the attention-free stack: the conv and ssm states alone."""
    _across_scan_chunks("falcon-mamba-7b", S)


def _across_scan_chunks(arch: str, S: int) -> None:
    jc, tc, jp, tp = _models(arch, seed=6)
    jb, tb = _batch(jc.vocab_size, 2, S, 19)
    jplan, tplan = jlm.ExecPlan(ssm_chunk=8), tlm.ExecPlan(ssm_chunk=8)
    assert _rel(tlm.forward_logits(tp, tc, tb, plan=tplan), jlm.forward_logits(jp, jc, jb, plan=jplan)) <= MODEL_TOL
    jl, jcache = jlm.batched_prefill(jp, jc, jb, cache_len=S + 2, plan=jplan)
    tl, tcache = tlm.batched_prefill(tp, tc, tb, cache_len=S + 2, plan=tplan)
    assert _rel(tl, jl) <= MODEL_TOL
    _assert_caches_match(tcache, jcache)
    tok = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    jl, jcache = jlm.decode_step(jp, jc, jnp.asarray(tok), jcache, jnp.int32(S))
    tl, tcache = tlm.decode_step(tp, tc, _t(tok).long(), tcache, S)
    assert _rel(tl, jl) <= MODEL_TOL
    _assert_caches_match(tcache, jcache)


@pytest.mark.parametrize("arch", MLA_HYBRID + ["falcon-mamba-7b"])
def test_bfloat16_mla_and_hybrid_forward_matches_the_reference(arch):
    jc, tc, jp, tp = _models(arch, "bfloat16", seed=1)
    jb, tb = _batch(jc.vocab_size, 2, 20, 12)
    mamba = [p for n, p in tp.named_parameters() if n.endswith("A_log")]
    assert all(p.dtype == torch.float32 for p in mamba) and len(mamba) == tc.num_layers * (arch != "minicpm3-4b")
    assert _rel(tlm.forward_logits(tp, tc, tb), jlm.forward_logits(jp, jc, jb)) <= BF16_TOL
