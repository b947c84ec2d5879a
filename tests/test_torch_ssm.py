"""The port's Mamba block (``repro_torch.models.ssm``) against the JAX reference (CPU).

The same numpy inputs, made from a seed, go through ``repro.models.ssm`` and the
port. ``init_mamba`` is bitwise the reference's in float32 and bfloat16, with
``A_log`` float32 under bfloat16, also after ``Module.to``. ``_causal_conv``, with
and without ``init_state``, is bitwise (the same products and sums in the same
order). The scans: the fused scan against the reference's ``_ssm_scan_fused``
and against the port's chunked scan contracted with C, the chunked scan
against the reference's, at T a multiple of the chunk, T not a multiple (the
last chunk padded) and T < K − 1, within ``LAYER_TOL`` of the largest value
(``tests/test_torch_lm.py``'s layer tolerance: the doubling scan associates
the products of dA in another order than jax's ``associative_scan``, a few
float32 ulps a step; 4.5e-7 at most here); the doubling scan within a chunk
against the float64 recurrence step by step. ``mamba_forward`` with
``return_state`` (output, conv tail, h_T), float32 within ``LAYER_TOL`` and
bfloat16 within ``BF16_TOL`` (an activation's bfloat16 rounding flips where two
float32 values differ by an ulp), and ``mamba_decode`` over several steps
continuing that state, each step against the reference's decode on the same
state, within the same tolerances.

The attention-free stack (falcon-mamba-7b, reduced: 2 layers of x +
mamba(norm1(x))), its weights carried over from the reference's tree: the
forward, the batched prefill, the token-by-token prefill and a decode step in
bfloat16 within ``BF16_TOL`` of the reference's, logits and the ``conv`` and
``ssm`` cache leaves (the reference's outputs once, in a module fixture;
``tests/test_torch_lm.py`` holds the float32 paths); the carried weights bitwise
the port's own draw for key 0 in both dtypes; and, the port alone in float32 at
16 layers × d 128, the token-by-token prefill within ``F32_CONSISTENCY_TOL`` of
the batched one.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm
from repro_torch.models import ssm as tssm
from repro_torch.utils import prng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

LAYER_TOL = 2e-6
BF16_TOL = 3e-2
D, C, N, R, K = 16, 24, 4, 3, 4
CHUNK = 8
LENGTHS = {"multiple": 16, "ragged": 21, "short": 2}  # T: whole chunks, a padded last chunk, T < K − 1


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(x, torch.Tensor) else \
        x.to(torch.float32).numpy()


def _params(dtype: str, seed: int = 1):
    """The reference's and the port's block from the same key."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jp = jssm.init_mamba(jax.random.PRNGKey(seed), D, d_inner=C, state=N, d_conv=K, dt_rank=R, dtype=jdt)
    tp = tssm.init_mamba(prng.prng_key(seed), D, d_inner=C, state=N, d_conv=K, dt_rank=R, dtype=tdt, device="cpu")
    return jp, tp


def _scan_inputs(T: int, seed: int):
    rs = np.random.default_rng(seed)
    u = rs.standard_normal((2, T, C)).astype(np.float32)
    dt = np.log1p(np.exp(rs.standard_normal((2, T, C)) - 3.0)).astype(np.float32)  # softplus: ~0.05, some near 1
    Bm = rs.standard_normal((2, T, N)).astype(np.float32)
    Cm = rs.standard_normal((2, T, N)).astype(np.float32)
    A = -np.broadcast_to(np.arange(1, N + 1, dtype=np.float32), (C, N)).copy()
    h0 = rs.standard_normal((2, C, N)).astype(np.float32)
    return u, dt, Bm, Cm, A, h0


@pytest.fixture(scope="module")
def scans():
    """The reference's fused and chunked scans, once for each length."""
    out = {}
    for name, T in LENGTHS.items():
        u, dt, Bm, Cm, A, h0 = x = _scan_inputs(T, T)
        y, hT = jssm._ssm_scan_fused(*(jnp.asarray(v) for v in x), CHUNK)
        dA = np.exp(dt[..., None] * A[None, None])
        dBu = (dt * u)[..., None] * Bm[:, :, None, :]
        hs, hT2 = jssm._ssm_scan_chunked(jnp.asarray(dA), jnp.asarray(dBu), jnp.asarray(h0), CHUNK)
        out[name] = dict(x=x, dA=dA, dBu=dBu, y=np.asarray(y), hT=np.asarray(hT), hs=np.asarray(hs),
                         hT2=np.asarray(hT2))
    return out


@pytest.fixture(scope="module")
def blocks():
    """The reference's mamba_forward (with its state) and four decode steps after
    it, once for each dtype and length."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        jp, tp = _params(dtype)
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        for name, T in LENGTHS.items():
            x = np.random.default_rng(100 + T).standard_normal((2, T + 4, D)).astype(np.float32)
            jx = jnp.asarray(x, jdt)
            y, (tail, hT) = jssm.mamba_forward(jp, jx[:, :T], state=N, dt_rank=R, chunk=CHUNK, return_state=True)
            steps, conv, ssm = [], tail, hT
            for t in range(T, T + 4):
                o, conv, ssm = jssm.mamba_decode(jp, jx[:, t : t + 1], conv, ssm, state=N, dt_rank=R)
                steps.append((_np(o), _np(conv), _np(ssm)))
            out[dtype, name] = dict(tp=tp, x=x, y=_np(y), tail=_np(tail), hT=_np(hT), steps=steps, T=T)
    return out


# ------------------------------------------------------------------ init


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_mamba_is_the_reference_init(dtype, seed):
    jp, tp = _params(dtype, seed)
    sd = tp.state_dict()
    assert set(sd) == set(jp)
    for name, want in jp.items():
        want_dtype = torch.float32 if want.dtype == jnp.float32 else torch.bfloat16
        assert sd[name].dtype == want_dtype, name
        assert np.array_equal(sd[name].to(torch.float32).numpy(), _np(want)), name
    assert sd["A_log"].dtype == torch.float32


def test_a_log_stays_float32_through_module_to():
    _, tp = _params("float32")
    want = tp.A_log.detach().clone()
    tp.to(torch.bfloat16)
    assert tp.in_proj.dtype == torch.bfloat16 and tp.A_log.dtype == torch.float32
    assert torch.equal(tp.A_log, want)
    tp.to(torch.float32)
    assert torch.equal(tp.A_log, want)


# ------------------------------------------------------------------ causal conv


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("length", list(LENGTHS))
def test_causal_conv_is_the_reference(length, with_state):
    rs = np.random.default_rng(LENGTHS[length] + 5 * with_state)
    u = rs.standard_normal((2, LENGTHS[length], C)).astype(np.float32)
    w, b = rs.standard_normal((K, C)).astype(np.float32), rs.standard_normal(C).astype(np.float32)
    st = rs.standard_normal((2, K - 1, C)).astype(np.float32) if with_state else None
    want = jssm._causal_conv(jnp.asarray(u), jnp.asarray(w), jnp.asarray(b),
                             None if st is None else jnp.asarray(st))
    got = tssm._causal_conv(_t(u), _t(w), _t(b), None if st is None else _t(st))
    assert np.array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------ scans


@pytest.mark.parametrize("T", [1, 5, 8, 128])
def test_scan_within_is_the_recurrence(T):
    """The doubling scan of one chunk against h_t = a_t·h_{t−1} + b_t in float64
    from h = 0 (b) and the running product (a)."""
    rs = np.random.default_rng(T)
    a = np.exp(-rs.random((2, T, 3, N)) * 2).astype(np.float32)
    b = rs.standard_normal((2, T, 3, N)).astype(np.float32)
    ga, gb = tssm._scan_within(_t(a), _t(b))
    ha, hb = np.ones((2, 3, N)), np.zeros((2, 3, N))
    want_a, want_b = [], []
    for t in range(T):
        ha, hb = a[:, t] * ha, a[:, t] * hb + b[:, t]
        want_a.append(ha)
        want_b.append(hb)
    assert _rel(ga, np.stack(want_a, 1)) <= LAYER_TOL and _rel(gb, np.stack(want_b, 1)) <= LAYER_TOL


@pytest.mark.parametrize("length", list(LENGTHS))
def test_fused_scan_matches_the_reference_and_the_chunked_scan(scans, length):
    r = scans[length]
    u, dt, Bm, Cm, A, h0 = (_t(v) for v in r["x"])
    y, hT = tssm._ssm_scan_fused(u, dt, Bm, Cm, A, h0, CHUNK)
    assert y.dtype == torch.float32 and tuple(y.shape) == r["y"].shape
    assert _rel(y, r["y"]) <= LAYER_TOL and _rel(hT, r["hT"]) <= LAYER_TOL
    hs, hT2 = tssm._ssm_scan_chunked(_t(r["dA"]), _t(r["dBu"]), h0, CHUNK)
    assert _rel(y, torch.einsum("btcn,btn->btc", hs, Cm)) <= LAYER_TOL and _rel(hT, hT2) <= LAYER_TOL


@pytest.mark.parametrize("length", list(LENGTHS))
def test_chunked_scan_matches_the_reference(scans, length):
    r = scans[length]
    dA, dBu = _t(r["dA"]), _t(r["dBu"])
    hs, hT = tssm._ssm_scan_chunked(dA, dBu, _t(r["x"][5]), CHUNK)
    assert tuple(hs.shape) == r["hs"].shape
    assert _rel(hs, r["hs"]) <= LAYER_TOL and _rel(hT, r["hT2"]) <= LAYER_TOL
    assert np.array_equal(dA.numpy(), r["dA"])  # the inputs are not written


# ------------------------------------------------------------------ the block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", list(LENGTHS))
def test_mamba_forward_with_state_matches_the_reference(blocks, length, dtype):
    r = blocks[dtype, length]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    x = _t(r["x"][:, : r["T"]]).to(tdt)
    y, (tail, hT) = tssm.mamba_forward(r["tp"], x, state=N, dt_rank=R, chunk=CHUNK, return_state=True)
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL
    assert y.dtype == tdt and tail.dtype == tdt and hT.dtype == torch.float32
    assert tuple(tail.shape) == (2, K - 1, C) == r["tail"].shape
    assert _rel(_np(y), r["y"]) <= tol and _rel(_np(hT), r["hT"]) <= tol
    assert np.array_equal(_np(tail), r["tail"])  # the pre-conv inputs: one product, the same rounding


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("length", list(LENGTHS))
def test_mamba_decode_continues_the_state_as_the_reference(blocks, length, dtype):
    """Four decode steps from the reference's own (tail, h_T), so each step is
    held against the reference's decode on the same state."""
    r = blocks[dtype, length]
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tol = LAYER_TOL if dtype == "float32" else BF16_TOL
    conv, ssm = _t(r["tail"]).to(tdt), _t(r["hT"])
    for i, (o_want, conv_want, ssm_want) in enumerate(r["steps"]):
        x = _t(r["x"][:, r["T"] + i : r["T"] + i + 1]).to(tdt)
        o, conv, ssm = tssm.mamba_decode(r["tp"], x, conv, ssm, state=N, dt_rank=R)
        assert o.dtype == tdt and conv.dtype == tdt and ssm.dtype == torch.float32
        assert _rel(_np(o), o_want) <= tol and _rel(_np(ssm), ssm_want) <= tol
        assert np.array_equal(_np(conv), conv_want)  # the last K − 1 pre-conv inputs, as they are


# ------------------------------------------------------------------ the attention-free stack (falcon-mamba-7b)

STACK_PATHS = ("forward", "batched_prefill", "token_prefill", "decode")
STACK_B, STACK_S = 2, 21  # the reduced stack's default scan chunk of 128 takes the prompt in one chunk
# The port's float32 token-by-token prefill against its batched prefill at a depth
# where the recurrence matters (16 layers × d 128, 40 tokens over chunks of 8):
# float32 sums in other orders, 4.6e-6 at most measured; the bfloat16 stack parts
# by 0.07 at the same depth.
F32_CONSISTENCY_TOL = 1e-4


def _stack_cfgs(dtype: str, **changes):
    import dataclasses

    from repro.configs import get_config as jget
    from repro_torch.configs import get_config as tget

    return (dataclasses.replace(jget("falcon-mamba-7b").reduced(), dtype=dtype, **changes),
            dataclasses.replace(tget("falcon-mamba-7b").reduced(), dtype=dtype, **changes))


@pytest.fixture(scope="module")
def stack():
    """The reduced falcon-mamba-7b in both packages, the port's carried over from
    the reference's tree, for each dtype; in bfloat16 also the reference's
    outputs: the forward over S + 1 tokens, the batched prefill of S (logits
    and cache), the token-by-token prefill of S (logits and cache), and one
    decode step after the batched prefill (``tests/test_torch_lm.py`` holds the
    same paths in float32)."""
    from repro.models import lm as jlm
    from repro_torch.models import lm as tlm

    out = {}
    toks = np.random.default_rng(31).integers(0, 256, (STACK_B, STACK_S + 1)).astype(np.int32)
    for dtype in ("float32", "bfloat16"):
        jc, tc = _stack_cfgs(dtype)
        jp = jlm.init_params(jc, jax.random.PRNGKey(0))
        tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        out[dtype] = dict(jc=jc, tc=tc, jp=jp, tp=tp, toks=toks)
        if dtype == "float32":
            continue
        head = {"tokens": jnp.asarray(toks[:, :STACK_S])}
        fwd = jlm.forward_logits(jp, jc, {"tokens": jnp.asarray(toks)})
        bl, bc = jlm.batched_prefill(jp, jc, head, cache_len=STACK_S + 4)
        tl, tcache = jlm.prefill(jp, jc, head, jlm.init_cache(jc, STACK_B, STACK_S + 4))
        dl, dc = jlm.decode_step(jp, jc, jnp.asarray(toks[:, STACK_S]), bc, jnp.int32(STACK_S))
        caches = lambda c: {n: _np(c[n]) for n in ("conv", "ssm")}
        out[dtype].update(forward=(_np(fwd), None), batched_prefill=(_np(bl), caches(bc)),
                          token_prefill=(_np(tl), caches(tcache)), decode=(_np(dl), caches(dc)))
    return out


def _port_stack_path(r, path: str):
    """The port's (logits, {"conv", "ssm"} or None) of one path on the fixture's tokens."""
    from repro_torch.models import lm as tlm

    tc, tp, toks = r["tc"], r["tp"], torch.from_numpy(r["toks"]).long()
    head = {"tokens": toks[:, :STACK_S]}
    if path == "forward":
        return tlm.forward_logits(tp, tc, {"tokens": toks}), None
    if path == "token_prefill":
        logits, cache = tlm.prefill(tp, tc, head, tlm.init_cache(tc, STACK_B, STACK_S + 4, device="cpu"))
        return logits, cache
    logits, cache = tlm.batched_prefill(tp, tc, head, cache_len=STACK_S + 4)
    if path == "decode":
        logits, cache = tlm.decode_step(tp, tc, toks[:, STACK_S], cache, STACK_S)
    return logits, cache


@pytest.mark.parametrize("path", STACK_PATHS)
def test_attention_free_stack_matches_the_reference_in_bfloat16(stack, path):
    """Each path of the reduced stack in bfloat16 (2 layers of x + mamba(norm1(x)),
    no attention, norm2 or FFN) against the reference's within BF16_TOL of the
    largest reference value; the cache's "conv" (bfloat16) and "ssm" (float32)
    leaf by leaf, and no other leaf."""
    r = stack["bfloat16"]
    want_logits, want_cache = r[path]
    logits, cache = _port_stack_path(r, path)
    assert logits.dtype == torch.float32 and tuple(logits.shape) == want_logits.shape
    assert _rel(_np(logits), want_logits) <= BF16_TOL
    if want_cache is not None:
        assert set(cache) == {"conv", "ssm"} and cache["ssm"].dtype == torch.float32
        assert cache["conv"].dtype == torch.bfloat16
        for name, want in want_cache.items():
            assert tuple(cache[name].shape) == want.shape and _rel(_np(cache[name]), want) <= BF16_TOL, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_free_weights_from_the_reference_are_the_ports_own_draw(stack, dtype):
    """The weights carried over from the reference's tree (key 0) are bitwise the
    port's own ``init_params`` for key 0: the same names, dtypes (``A_log``
    float32) and values."""
    from repro_torch.models import lm as tlm

    r = stack[dtype]
    own = tlm.init_params(r["tc"], prng.prng_key(0), device="cpu").state_dict()
    carried = r["tp"].state_dict()
    assert carried.keys() == own.keys()
    assert not any(".attn." in n or ".ffn." in n or "norm2" in n for n in own)
    for name, t in own.items():
        assert t.dtype == carried[name].dtype and torch.equal(t, carried[name]), name


def test_attention_free_float32_token_prefill_is_the_batched_prefill_at_depth():
    """The port alone, float32, 16 layers × d 128 over 40 tokens in scan chunks of 8:
    the token-by-token prefill (one recurrent decode step a token) and the
    batched prefill (the chunked scan) give the same logits and states within
    F32_CONSISTENCY_TOL, and the forward's last position is the batched prefill's."""
    from repro_torch.models import lm as tlm

    _, tc = _stack_cfgs("float32", num_layers=16, d_model=128, dt_rank=8)
    model = tlm.init_params(tc, prng.prng_key(0), device="cpu")
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, tc.vocab_size, (2, 40)))
    plan = tlm.ExecPlan(ssm_chunk=8)
    lb, cb = tlm.batched_prefill(model, tc, {"tokens": toks}, plan=plan)
    lt, ct = tlm.prefill(model, tc, {"tokens": toks}, tlm.init_cache(tc, 2, 40, device="cpu"))
    full = tlm.forward_logits(model, tc, {"tokens": toks}, plan=plan)
    assert float((lt - lb).abs().max()) <= F32_CONSISTENCY_TOL
    assert all(float((ct[n] - cb[n]).abs().max()) <= F32_CONSISTENCY_TOL for n in ("conv", "ssm"))
    assert float((full[:, -1] - lb).abs().max()) <= F32_CONSISTENCY_TOL
