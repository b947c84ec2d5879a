"""Sketched head fitting on the port's LM features against the JAX reference (CPU).

``train.solvers.extract_features`` (final-norm hidden states, (B·S, d) float32)
within ``FEATURE_TOL`` of ``repro.train.solvers.extract_features`` on the same
weights and ``lm_batch`` tokens, granite, chatglm, mixtral, gemma3, grok,
minicpm3, hymba, whisper (with frames), pixtral (with patches) and falcon reduced
(float32 through two to six layers, sums in other orders: relative to the
largest feature). Then the
smoke's head-fitting problem at a small size: Y = H·U[:, ids] + 0.1·noise with U
the model's own unembedding, fit by ``fit_head`` with ``use_kernel=False``
(Gaussian and SJLT, a straggler mask) within ``FIT_TOL`` of the reference's
``fit_head`` on the same H and Y (relative, ∞-norm; the q d×d ridge solves
amplify the Grams' float32 differences by the small conditioning of (G + reg·I),
as in ``tests/test_torch_head_fit.py``), and within 3× of Theorem 1.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.core import sketches as jsk
from repro.data import tokens as jtok
from repro.models import lm as jlm
from repro.train import solvers as jsolvers
from repro_torch.configs import get_config as tget
from repro_torch.core import sketches as tsk, theory
from repro_torch.data import tokens as ttok
from repro_torch.models import lm as tlm
from repro_torch.train import solvers as tsolvers
from repro_torch.utils import prng

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

FEATURE_TOL = 1e-5
FIT_TOL = 1e-5
Q, M, K = 8, 384, 4
MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _features(arch, B=8, S=96):
    jc, tc = jget(arch).reduced(), tget(arch).reduced()
    jp = jlm.init_params(jc, jax.random.PRNGKey(1))
    tp = tlm.params_from_reference(tc, jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    jb = jtok.lm_batch(4, 0, batch=B, seq=S, vocab=jc.vocab_size)
    tb = ttok.lm_batch(4, 0, batch=B, seq=S, vocab=tc.vocab_size, device="cpu")
    if jc.encdec or jc.vlm:  # the frontend stub, N(0, 1)
        stub = "frames" if jc.encdec else "patches"
        shape = (B, jc.enc_seq, jc.d_model) if jc.encdec else (B, jc.num_image_tokens, jc.vit_dim)
        a = np.random.default_rng(9).standard_normal(shape).astype(np.float32)
        jb, tb = dict(jb, **{stub: jnp.asarray(a)}), dict(tb, **{stub: torch.from_numpy(a)})
    want = np.asarray(jsolvers.extract_features(jp, jc, jb))
    got = tsolvers.extract_features(tp, tc, tb)
    return tc, tp, got, want


@pytest.mark.parametrize("arch", ["granite-3-8b", "chatglm3-6b", "mixtral-8x7b", "gemma3-12b", "grok-1-314b",
                                  "minicpm3-4b", "hymba-1.5b", "whisper-small", "pixtral-12b", "falcon-mamba-7b"])
def test_extract_features_matches_the_reference(arch):
    tc, _, got, want = _features(arch, B=2, S=24)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (48, tc.d_model)
    assert _rel(got, want) <= FEATURE_TOL


@pytest.mark.parametrize("kind", ["gaussian", "sjlt"])
def test_fit_head_on_lm_features_matches_the_reference(kind):
    tc, tp, H, _ = _features("granite-3-8b")
    n, d = H.shape  # 768 × 64
    U = tp.unembed_w()[:, [3, 50, 101, 200]].to(torch.float32)
    Y = (H @ U + 0.1 * prng.normal(prng.prng_key(2), (n, K))).numpy()
    Hn = H.numpy()
    jkey = jax.random.PRNGKey(5)
    tkey = prng.from_key_data(np.asarray(jax.random.key_data(jkey)))
    want = jsolvers.fit_head(jkey, jnp.asarray(Hn), jnp.asarray(Y), jsk.SketchSpec(kind, M, s=4), q=Q, reg=1e-4,
                             straggler_mask=jnp.asarray(MASK))
    spec = tsk.SketchSpec(kind, M, s=4, use_kernel=False)
    W = tsolvers.fit_head(tkey, torch.from_numpy(Hn), torch.from_numpy(Y), spec, q=Q, reg=1e-4,
                          straggler_mask=torch.from_numpy(MASK), device="cpu")
    assert tuple(W.shape) == (d, K) and _rel(W.numpy(), np.asarray(want)) <= FIT_TOL
    quality = tsolvers.head_fit_quality(torch.from_numpy(Hn), torch.from_numpy(Y), W)
    pred = theory.gaussian_averaged_error(M, d, int(MASK.sum()))
    assert pred / 3 <= quality["rel_err"] <= 3 * pred
