"""The port's LM loss and train step against the JAX reference (CPU, float32).

The reference's tiny test model (``tests/_torch_lm_train.py``: 2 layers, d 32,
vocab 97), its weights for key 0 carried into the port, one ``lm_batch`` of
4 × 32 tokens, ``attn_chunk`` 16 and ``loss_chunk`` 8 (31 predicted positions:
a short last chunk). ``lm_loss`` and its gradient, for each ``remat``, against
``jax.value_and_grad(lm.lm_loss)`` under the same plan: the loss within
LOSS_TOL, each gradient leaf within GRAD_TOL of that leaf's largest reference
entry (float32 through two layers and their backward, sums in other orders).
The port's three ``remat`` values give bitwise the same loss and gradient. The
same for the reduced mixtral (float32, 4 experts, top-2 at capacity 1.25) with
its non-zero MoE auxiliary term, each ``remat``.
``make_train_step`` with ``accum_steps`` 1 and 2 (microbatches summed in
float32) against the reference's jitted step: the loss within LOSS_TOL, the
parameters after the step within STEP_TOL of each leaf's largest entry. AdamW's
eps is 1e-4 here, so the update is Lipschitz in the gradient (1/eps) and a
float32 gradient difference cannot flip the sign of a near-zero update.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_lm_train as lt
from repro.data import tokens as jtok
from repro.models import lm as jlm
from repro.optim import AdamWConfig as JAdamW, init_opt_state as jinit_opt
from repro.train import state as jstate, step as jstep
from repro_torch.data import tokens as ttok
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig as TAdamW
from repro_torch.train import step as tstep

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

LOSS_TOL = 1e-6
GRAD_TOL = 2e-5
STEP_TOL = 1e-5
REMATS = ["none", "full", "dots"]
EPS = 1e-4


@pytest.fixture(scope="module")
def ref():
    jcfg, tcfg = lt.configs()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jbatch = jtok.lm_batch(0, 0, batch=lt.BATCH, seq=lt.SEQ, vocab=jcfg.vocab_size)
    tbatch = ttok.lm_batch(0, 0, batch=lt.BATCH, seq=lt.SEQ, vocab=tcfg.vocab_size, device="cpu")
    return jcfg, tcfg, jparams, jbatch, tbatch


@pytest.fixture(scope="module")
def port_grads(ref):
    """The port's (loss, grads by name) for each remat."""
    _, tcfg, jparams, _, tbatch = ref
    out = {}
    for remat in REMATS:
        st = lt.port_state(tcfg, jparams, TAdamW())
        loss, aux = tlm.lm_loss(st["params"], tcfg, tbatch, plan=tlm.ExecPlan(attn_chunk=16, loss_chunk=8,
                                                                              remat=remat))
        loss.backward()
        out[remat] = (loss.detach(), {k: v.detach() for k, v in aux.items()}, tstep.take_grads(st["params"]))
    return out


@pytest.mark.parametrize("remat", REMATS)
def test_lm_loss_and_grad_match_reference(ref, port_grads, remat):
    jcfg, _, jparams, jbatch, _ = ref
    plan = jlm.ExecPlan(attn_chunk=16, loss_chunk=8, remat=remat)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jlm.lm_loss(p, jcfg, b, plan=plan), has_aux=True))(jparams, jbatch)
    loss, aux, grads = port_grads[remat]
    assert abs(float(loss) - float(jloss)) <= LOSS_TOL * abs(float(jloss))
    assert abs(float(aux["ce"]) - float(jaux["ce"])) <= LOSS_TOL * abs(float(jaux["ce"]))
    assert float(aux["moe_aux"]) == float(jaux["moe_aux"]) == 0.0
    for name, g in grads.items():
        want = lt.ref_leaf(jgrads, name)
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GRAD_TOL, (name, err)
    for name in grads:
        assert torch.equal(grads[name], port_grads["none"][2][name]), name
    assert torch.equal(loss, port_grads["none"][0])


@pytest.fixture(scope="module")
def moe_ref():
    """The reduced mixtral (float32, 2 layers, 4 experts, top-2 at capacity 1.25),
    its weights for key 0 and one lm_batch of 4 × 32 tokens in both packages, and
    the reference's jitted ``value_and_grad`` of ``lm_loss`` on them (remat none:
    the reference's remat policies change what is stored, not the gradient)."""
    jcfg, tcfg = lt.moe_configs()
    jparams = jlm.init_params(jcfg, jax.random.PRNGKey(0))
    jbatch = jtok.lm_batch(0, 0, batch=lt.BATCH, seq=lt.SEQ, vocab=jcfg.vocab_size)
    tbatch = ttok.lm_batch(0, 0, batch=lt.BATCH, seq=lt.SEQ, vocab=tcfg.vocab_size, device="cpu")
    plan = jlm.ExecPlan(attn_chunk=16, loss_chunk=8, remat="none")
    want = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, jcfg, b, plan=plan), has_aux=True))(jparams, jbatch)
    return jcfg, tcfg, jparams, tbatch, want


@pytest.mark.parametrize("remat", REMATS)
def test_moe_lm_loss_and_grad_match_reference(moe_ref, remat):
    """``lm_loss`` of the MoE model with its non-zero auxiliary term and its
    gradient through the router, the experts and the dispatch's gathers and
    index writes (slots dropped at capacity 1.25), under each of the port's
    ``remat`` values, against ``jax.value_and_grad`` of the reference's loss:
    the loss, its CE and MoE terms within LOSS_TOL, each gradient leaf within
    GRAD_TOL of its largest entry."""
    jcfg, tcfg, jparams, tbatch, ((jloss, jaux), jgrads) = moe_ref
    st = lt.port_state(tcfg, jparams, TAdamW())
    loss, aux = tlm.lm_loss(st["params"], tcfg, tbatch, plan=tlm.ExecPlan(attn_chunk=16, loss_chunk=8, remat=remat))
    loss.backward()
    assert float(jaux["moe_aux"]) > 0
    for got, want in ((loss, jloss), (aux["ce"], jaux["ce"]), (aux["moe_aux"], jaux["moe_aux"])):
        assert abs(float(got.detach()) - float(want)) <= LOSS_TOL * abs(float(want))
    grads = tstep.take_grads(st["params"])
    assert any(".moe.router" in n for n in grads)
    for name, g in grads.items():
        want = lt.ref_leaf(jgrads, name)
        err = np.abs(g.numpy() - want).max() / max(np.abs(want).max(), 1e-30)
        assert err <= GRAD_TOL, (name, err)


def test_lm_loss_refuses_an_unknown_remat(ref):
    _, tcfg, jparams, _, tbatch = ref
    st = lt.port_state(tcfg, jparams, TAdamW())
    with pytest.raises(ValueError, match="remat"):
        tlm.lm_loss(st["params"], tcfg, tbatch, plan=tlm.ExecPlan(remat="some"))


@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_matches_reference(ref, accum):
    jcfg, tcfg, jparams, jbatch, tbatch = ref
    jopt, topt = JAdamW(lr=1e-3, eps=EPS), TAdamW(lr=1e-3, eps=EPS)
    jst = {"params": jparams, "opt": jinit_opt(jopt, jparams),
           "step": jnp.zeros((), jnp.int32)}
    jnew, jm = jax.jit(jstep.make_train_step(jcfg, jopt, remat="full", accum_steps=accum))(jst, jbatch)
    st = lt.port_state(tcfg, jparams, topt)
    st, m = tstep.make_train_step(tcfg, topt, remat="full", accum_steps=accum)(st, tbatch)
    assert int(st["step"]) == int(jnew["step"]) == 1
    assert abs(float(m["loss"]) - float(jm["loss"])) <= LOSS_TOL * abs(float(jm["loss"]))
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=GRAD_TOL)
    assert lt.max_rel(st["params"], jnew["params"]) <= STEP_TOL


def test_train_state_shapes_allocate_nothing_and_match_init():
    _, tcfg = lt.configs()
    from repro_torch.train import state as tstate
    from repro_torch.utils import prng

    like = tstate.train_state_shapes(tcfg, TAdamW())
    real = tstate.init_train_state(tcfg, TAdamW(), prng.prng_key(0), device="cpu")
    assert all(p.device.type == "meta" for p in like["params"].parameters())
    assert {n: (p.shape, p.dtype) for n, p in like["params"].named_parameters()} == {
        n: (p.shape, p.dtype) for n, p in real["params"].named_parameters()}
    assert like["opt"]["mu"].keys() == real["opt"]["mu"].keys() and like["step"].dtype == torch.int32
    jst = jstate.init_train_state(lt.configs()[0], JAdamW(), jax.random.PRNGKey(0))
    for name, p in real["params"].named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), lt.ref_leaf(jst["params"], name))
