"""The port's LM serving (``serve.Engine``, ``sample_token``, ``launch.serve --arch``)
against the JAX reference on the CPU.

``sample_token`` is bitwise the reference's on the same logits, greedy and at
temperature > 0 (jax's categorical: gumbel noise under the key plus logits / T).
``Engine.generate`` gives the reference's tokens on ``tests/test_serve.py``'s
config (parameters converted from the reference's tree), greedy and sampled,
where every step's logits agree within ``LOGIT_TOL`` (float32 through two layers:
1.9e-6 at most here, sums in other orders) and the reference's smallest
top-2 margin along the run (of the sampled scores g + logits/T when sampling)
exceeds 10·LOGIT_TOL, so equal tokens are what the logits' agreement implies.
The same on the reduced mixtral-8x7b (MoE at its config's capacity 1.25, so
the decode's batch-wide groups drop assignments; sliding window 8) and
gemma3-12b (local:global, window 8) with prompts past the window, so the rings
wrap in the prefill and again in decode, and on the reduced hymba-1.5b (GQA
with window 8 beside Mamba: the left-padding runs through the SSM's recurrence
as ordinary tokens, as in the reference) and falcon-mamba-7b (the
attention-free Mamba stack: the same, with no attention at all); and on the reduced whisper-small fed
frames and pixtral-12b fed patches (more rows than the batch: each engine batch
takes the first B, as in the reference; the patches take the first positions
of the left-padded rectangle). The port's own determinism, batched = single,
several engine batches and EOS trimming are the reference's tests repeated;
the launcher's LM mode prints the reference launcher's tokens, also for
mixtral, gemma3 and whisper-small (its frames drawn as the reference
launcher's).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jget
from repro.models import lm as jlm
from repro.serve import Engine as JEngine, ServeConfig as JServeConfig
from repro.serve.engine import sample_token as jsample
from repro_torch.configs import get_config as tget
from repro_torch.models import lm as tlm
from repro_torch.serve import Engine, ServeConfig, sample_token
from repro_torch.utils import prng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGIT_TOL = 2e-5  # 10× the largest difference seen on this config (1.9e-6)
SMALL = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1, head_dim=16, vocab_size=97)


def _setup(max_batch=4, temperature=0.0, eos_id=-1, seed=0):
    jc = dataclasses.replace(jget("granite-3-8b").reduced(), **SMALL)
    tc = dataclasses.replace(tget("granite-3-8b").reduced(), **SMALL)
    jp = jlm.init_params(jc, jax.random.PRNGKey(0))
    tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    kw = dict(max_batch=max_batch, max_len=64, temperature=temperature, eos_id=eos_id, seed=seed)
    return JEngine(jc, jp, JServeConfig(**kw)), Engine(tc, tp, ServeConfig(**kw), device="cpu")


def _key(seed):
    return jax.random.PRNGKey(seed), prng.prng_key(seed)


@pytest.mark.parametrize("temperature", [0.0, 0.7, 1.3])
def test_sample_token_is_bitwise_the_reference(temperature):
    logits = (2 * np.random.default_rng(1).standard_normal((5, 300))).astype(np.float32)
    for seed in (0, 9):
        jk, tk = _key(seed)
        jk, tk = jax.random.split(jk)[1], prng.split(tk)[1]  # a key of the engine's schedule
        want = np.asarray(jsample(jk, jnp.asarray(logits), temperature))
        got = sample_token(tk, torch.from_numpy(logits), temperature).numpy()
        assert np.array_equal(got, want)


def _reference_path(jeng, prompts, new, stubs=None):
    """The reference engine's generation with its logits at every step (its own
    prefill and decode, its key schedule), and the smallest top-2 margin of what
    it took the argmax of. ``stubs``: the batch's frames or patches."""
    sc = jeng.sc
    S = max(len(p) for p in prompts)
    toks = np.zeros((len(prompts), S), np.int32)
    for r, p in enumerate(prompts):
        toks[r, S - len(p):] = p
    logits, cache = jeng._prefill(jeng.params, {"tokens": jnp.asarray(toks), **(stubs or {})})
    key = jax.random.PRNGKey(sc.seed)
    steps, keys = [np.asarray(logits)], [key]
    for t in range(1, new):
        tok = jsample(keys[-1], logits, sc.temperature)
        key, sub = jax.random.split(key)
        _, logits, cache = jeng._decode(jeng.params, tok, cache, jnp.int32(S + t - 1), sub)
        steps.append(np.asarray(logits))
        keys.append(sub)
    margin = np.inf
    for lg, k in zip(steps, keys):
        score = lg / sc.temperature if sc.temperature > 0 else lg
        if sc.temperature > 0:
            score = score + np.asarray(jax.random.gumbel(k, lg.shape))
        top2 = np.sort(score, axis=-1)[:, -2:]
        margin = min(margin, float((top2[:, 1] - top2[:, 0]).min()))
    return steps, margin


@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_matches_the_reference(temperature):
    jeng, teng = _setup(temperature=temperature, seed=3)
    prompts = [[1, 2, 3, 4, 5], [7, 8, 9], [11, 3, 5, 8, 13, 21]]
    want = jeng.generate(prompts, max_new_tokens=7)
    got = teng.generate(prompts, max_new_tokens=7)
    steps, margin = _reference_path(jeng, prompts, 7)
    assert margin > 10 * LOGIT_TOL, f"the reference's top-2 margin {margin} is too small to decide"
    # the port's logits along the same tokens
    S = max(len(p) for p in prompts)
    toks = torch.zeros((3, S), dtype=torch.int64)
    for r, p in enumerate(prompts):
        toks[r, S - len(p):] = torch.tensor(p)
    with torch.inference_mode():
        logits, cache = teng._prefill(toks)
        assert np.abs(logits.numpy() - steps[0]).max() <= LOGIT_TOL
        for t in range(1, 7):
            tok = torch.tensor([o[t - 1] for o in got])
            _, logits, cache = teng._decode(tok, cache, S + t - 1, prng.prng_key(0))
            assert np.abs(logits.numpy() - steps[t]).max() <= LOGIT_TOL
    assert got == want


NEW_ARCHS = ["mixtral-8x7b", "gemma3-12b"]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", NEW_ARCHS + ["hymba-1.5b", "falcon-mamba-7b"])
def test_generate_matches_the_reference_on_moe_and_windowed_archs(arch, temperature):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    kw = dict(max_batch=4, max_len=40, temperature=temperature, seed=4)
    jeng, teng = JEngine(jc, jp, JServeConfig(**kw)), Engine(tc, tp, ServeConfig(**kw), device="cpu")
    prompts = [list(range(3, 17)), [9, 4, 200, 31, 7, 7, 18, 90, 2, 11, 5], list(range(250, 238, -1))]
    new = 12  # decode positions 14…25: past the window of 8 again
    want = jeng.generate(prompts, max_new_tokens=new)
    steps, margin = _reference_path(jeng, prompts, new)
    assert margin > 10 * LOGIT_TOL, f"the reference's top-2 margin {margin} is too small to decide"
    got = teng.generate(prompts, max_new_tokens=new)
    S = max(len(p) for p in prompts)
    toks = torch.zeros((3, S), dtype=torch.int64)
    for r, p in enumerate(prompts):
        toks[r, S - len(p):] = torch.tensor(p)
    with torch.inference_mode():
        logits, cache = teng._prefill(toks)
        assert np.abs(logits.numpy() - steps[0]).max() <= LOGIT_TOL
        for t in range(1, new):
            tok = torch.tensor([o[t - 1] for o in got])
            _, logits, cache = teng._decode(tok, cache, S + t - 1, prng.prng_key(0))
            assert np.abs(logits.numpy() - steps[t]).max() <= LOGIT_TOL
    assert got == want


ENCDEC_VLM = ["whisper-small", "pixtral-12b"]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("arch", ENCDEC_VLM)
def test_generate_matches_the_reference_with_frames_or_patches(arch, temperature):
    """Three prompts of 14, 11 and 12 tokens with 4 rows of frames or patches,
    of which the batch takes the first 3; pixtral's 4 patches cover the shorter
    prompts' 3 and 2 padding positions and then their first tokens, as in the
    reference."""
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    kw = dict(max_batch=4, max_len=40, temperature=temperature, seed=4)
    jeng, teng = JEngine(jc, jp, JServeConfig(**kw)), Engine(tc, tp, ServeConfig(**kw), device="cpu")
    stub = "frames" if jc.encdec else "patches"
    shape = (4, jc.enc_seq, jc.d_model) if jc.encdec else (4, jc.num_image_tokens, jc.vit_dim)
    rows = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    prompts = [list(range(3, 17)), [9, 4, 200, 31, 7, 7, 18, 90, 2, 11, 5], list(range(250, 238, -1))]
    new = 12
    want = jeng.generate(prompts, max_new_tokens=new, **{stub: jnp.asarray(rows)})
    steps, margin = _reference_path(jeng, prompts, new, {stub: jnp.asarray(rows[:3])})
    assert margin > 10 * LOGIT_TOL, f"the reference's top-2 margin {margin} is too small to decide"
    got = teng.generate(prompts, max_new_tokens=new, **{stub: torch.from_numpy(rows)})
    S = max(len(p) for p in prompts)
    toks = torch.zeros((3, S), dtype=torch.int64)
    for r, p in enumerate(prompts):
        toks[r, S - len(p):] = torch.tensor(p)
    with torch.inference_mode():
        logits, cache = teng._prefill(toks, **{stub: torch.from_numpy(rows[:3])})
        assert np.abs(logits.numpy() - steps[0]).max() <= LOGIT_TOL
        for t in range(1, new):
            tok = torch.tensor([o[t - 1] for o in got])
            _, logits, cache = teng._decode(tok, cache, S + t - 1, prng.prng_key(0))
            assert np.abs(logits.numpy() - steps[t]).max() <= LOGIT_TOL
    assert got == want


def test_generate_shapes_and_determinism():
    _, engine = _setup()
    prompts = [[1, 2, 3, 4], [5, 6, 7, 8]]
    a = engine.generate(prompts, max_new_tokens=6)
    b = engine.generate(prompts, max_new_tokens=6)
    assert a == b
    assert len(a) == 2 and all(len(o) == 6 for o in a)
    assert all(t < engine.cfg.vocab_size for o in a for t in o)  # padded ids masked


def test_sampled_generation_is_deterministic_and_seeded():
    _, e1 = _setup(temperature=0.9, seed=5)
    _, e2 = _setup(temperature=0.9, seed=6)
    prompts = [[3, 1, 4, 1, 5]]
    assert e1.generate(prompts, max_new_tokens=8) == e1.generate(prompts, max_new_tokens=8)
    assert e1.generate(prompts, max_new_tokens=8) != e2.generate(prompts, max_new_tokens=8)


def test_batched_equals_rectangular_single():
    """Greedy decode of equal-length prompts does not depend on batch packing."""
    _, engine = _setup()
    p1, p2 = [3, 1, 4, 1], [2, 7, 1, 8]
    both = engine.generate([p1, p2], max_new_tokens=5)
    assert both[0] == engine.generate([p1], max_new_tokens=5)[0]
    assert both[1] == engine.generate([p2], max_new_tokens=5)[0]


def test_multi_chunk_queue():
    jeng, engine = _setup(max_batch=2)
    prompts = [[i + 1, i + 2, i + 3] for i in range(5)]  # 3 engine batches
    outs = engine.generate(prompts, max_new_tokens=4)
    assert len(outs) == 5 and outs == jeng.generate(prompts, max_new_tokens=4)


def test_eos_trimming():
    _, probe = _setup()
    row = probe.generate([[1, 2, 3]], max_new_tokens=8)[0]
    eos = row[2]  # a token this prompt generates: the engine must stop there
    _, engine = _setup(max_batch=2, eos_id=eos)
    out = engine.generate([[1, 2, 3]], max_new_tokens=8)[0]
    assert out[-1] == eos and eos not in out[:-1] and out == row[: row.index(eos) + 1]


def test_generate_refuses_past_max_len():
    _, engine = _setup()
    with pytest.raises(ValueError, match="max_len"):
        engine.generate([list(range(60))], max_new_tokens=8)


def test_engine_uses_the_model_as_given_and_refuses_another_device():
    _, engine = _setup()
    model = engine.params
    assert Engine(engine.cfg, model, engine.sc, device="cpu").params is model
    model.to("meta")
    with pytest.raises(ValueError, match="the model is on meta"):
        Engine(engine.cfg, model, engine.sc, device="cpu")
    assert next(model.parameters()).device.type == "meta"


def _launch(module, *args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)


def test_launcher_lm_mode_prints_the_reference_tokens():
    got = _launch("repro_torch.launch.serve", "--arch", "granite-3-8b", "--reduced", "--device", "cpu")
    want = _launch("repro.launch.serve", "--arch", "granite-3-8b", "--reduced")
    assert got.returncode == 0, got.stderr[-2000:]
    assert want.returncode == 0, want.stderr[-2000:]
    lines = got.stdout.strip().splitlines()
    assert lines[0].startswith("arch=granite-3-8b requests=6 new_tokens=96 ")
    assert [l for l in lines if l.startswith("  req")] == [l for l in want.stdout.splitlines() if l.startswith("  req")]


@pytest.mark.parametrize("arch", NEW_ARCHS + ["whisper-small"])
def test_launcher_lm_mode_prints_the_reference_tokens_for_moe_and_windowed_archs(arch):
    got = _launch("repro_torch.launch.serve", "--arch", arch, "--reduced", "--device", "cpu")
    want = _launch("repro.launch.serve", "--arch", arch, "--reduced")
    assert got.returncode == 0, got.stderr[-2000:]
    assert want.returncode == 0, want.stderr[-2000:]
    lines = got.stdout.strip().splitlines()
    assert lines[0].startswith(f"arch={arch} requests=6 new_tokens=96 ")
    assert [l for l in lines if l.startswith("  req")] == [l for l in want.stdout.splitlines() if l.startswith("  req")]
