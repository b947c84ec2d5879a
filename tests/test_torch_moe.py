"""The port's MoE feed-forward (``repro_torch.models.moe``) against the JAX
reference ``repro.models.moe`` on the CPU, float32, seeded numpy inputs.

``moe_forward`` at capacity factors 0.5 and 1.25 (assignments dropped) and E
(dropless), for 4 and 8 experts, top-2: the routed expert ids equal the
reference's, the output within ``LAYER_TOL`` of its largest entry (float32
products in other orders) and the aux loss within ``LAYER_TOL``. The dense
fallback likewise, and the dispatch at dropless capacity equals the fallback.
The tie rule: equal router probabilities (zero router columns, so the logits
are exactly equal) take the lower expert id first, as ``jax.lax.top_k``, and
the capacity then drops the same assignments. The decode grouping: x of
(1, B, d), the batch one group. The drop counter counts what the capacity rule
drops and each expert's load.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe as tmoe

# The suite runs in several worker processes at once; one torch thread each keeps
# them from oversubscribing the cores (each op's thread team waits on the others).
torch.set_num_threads(1)

LAYER_TOL = 2e-6
D, F = 32, 48
SHAPES = {"prefill": (3, 13), "decode": (1, 8)}  # (G, T); decode: the batch of 8 is one group


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _weights(E, seed, router=None):
    rs = np.random.default_rng(seed)
    w = {"router": (rs.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32),
         "w_gate": (rs.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
         "w_up": (rs.standard_normal((E, D, F)) / np.sqrt(D)).astype(np.float32),
         "w_down": (rs.standard_normal((E, F, D)) / np.sqrt(F)).astype(np.float32)}
    if router is not None:
        w["router"] = router
    return w


def _pair(w):
    jp = {k: jnp.asarray(v) for k, v in w.items()}
    tp = tmoe.MoE(*(torch.from_numpy(w[n].copy()) for n in ("router", "w_gate", "w_up", "w_down")))
    return jp, tp


def _x(G, T, seed):
    return np.random.default_rng(seed).standard_normal((G, T, D)).astype(np.float32)


@pytest.fixture(scope="module")
def reference():
    """The reference's outputs, once per (E, shape, capacity factor)."""
    cache = {}

    def get(E, shape, cf, seed=0):
        k = (E, shape, cf, seed)
        if k not in cache:
            w = _weights(E, seed)
            x = _x(*SHAPES[shape], seed + 1)
            jp, _ = _pair(w)
            out, aux = jmoe.moe_forward(jp, jnp.asarray(x), num_experts=E, top_k=2, capacity_factor=cf)
            _, ids, _ = jmoe._route(jp, jnp.asarray(x), E, 2)
            cache[k] = (w, x, np.asarray(out), float(aux), np.asarray(ids))
        return cache[k]

    return get


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cf", [0.5, 1.25, "E"])
@pytest.mark.parametrize("E", [4, 8])
def test_moe_forward_matches_the_reference(reference, E, cf, shape):
    cf = float(E) if cf == "E" else cf
    w, x, want, want_aux, want_ids = reference(E, shape, cf)
    _, tp = _pair(w)
    _, ids, _ = tmoe.route(tp, torch.from_numpy(x), E, 2)
    assert np.array_equal(ids.numpy(), want_ids)
    out, aux = tmoe.moe_forward(tp, torch.from_numpy(x), num_experts=E, top_k=2, capacity_factor=cf)
    assert out.dtype == torch.float32 and tuple(out.shape) == want.shape
    assert _rel(out, want) <= LAYER_TOL
    assert abs(float(aux) - want_aux) <= LAYER_TOL * abs(want_aux)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("E", [4, 8])
def test_dense_fallback_matches_the_reference_and_the_dropless_dispatch(E, shape):
    w, x = _weights(E, 3), _x(*SHAPES[shape], 4)
    jp, tp = _pair(w)
    want, want_aux = jmoe.moe_dense_fallback(jp, jnp.asarray(x), num_experts=E, top_k=2)
    got, aux = tmoe.moe_dense_fallback(tp, torch.from_numpy(x), num_experts=E, top_k=2)
    assert _rel(got, want) <= LAYER_TOL and abs(float(aux) - float(want_aux)) <= LAYER_TOL * abs(float(want_aux))
    routed, _ = tmoe.moe_forward(tp, torch.from_numpy(x), num_experts=E, top_k=2, capacity_factor=float(E))
    assert _rel(routed, got) <= LAYER_TOL


@pytest.mark.parametrize("zero_cols", [[0, 1, 2, 3], [1, 2, 3], [0, 2]])
@pytest.mark.parametrize("cf", [1.25, 4.0])
def test_ties_take_the_lower_expert_first(zero_cols, cf):
    """Zero router columns give bitwise-equal logits, so those experts' probabilities
    tie; jax.lax.top_k takes the lower id first, and so must the port (its
    capacity then drops the same assignments)."""
    E = 4
    router = _weights(E, 5)["router"]
    router[:, zero_cols] = 0.0
    w, x = _weights(E, 5, router), _x(2, 11, 6)
    jp, tp = _pair(w)
    _, want_ids, _ = jmoe._route(jp, jnp.asarray(x), E, 2)
    _, ids, _ = tmoe.route(tp, torch.from_numpy(x), E, 2)
    assert np.array_equal(ids.numpy(), np.asarray(want_ids))
    if len(zero_cols) == E:
        assert (ids.numpy() == [0, 1]).all()
    want, _ = jmoe.moe_forward(jp, jnp.asarray(x), num_experts=E, top_k=2, capacity_factor=cf)
    got, _ = tmoe.moe_forward(tp, torch.from_numpy(x), num_experts=E, top_k=2, capacity_factor=cf)
    assert _rel(got, want) <= LAYER_TOL


def test_top_k_is_jax_top_k_with_many_ties():
    v = np.random.default_rng(7).integers(0, 4, (50, 9)).astype(np.float32)
    for k in (1, 2, 5, 9):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = tmoe.top_k_stable(torch.from_numpy(v), k)
        assert np.array_equal(ti.numpy(), np.asarray(ji)) and np.array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("cf,T,E,k", [(1.25, 8, 8, 2), (1.25, 6144, 8, 2), (0.5, 3, 4, 2), (8.0, 5, 8, 2),
                                      (1.25, 1, 8, 2), (0.01, 7, 4, 1)])
def test_capacity_is_the_reference_rule(cf, T, E, k):
    assert tmoe.capacity(cf, k, T, E) == min(max(1, int(cf * k * T / E)), T * k)


def test_drop_counter_counts_what_the_capacity_drops():
    E, (G, T) = 4, SHAPES["prefill"]
    w, x = _weights(E, 8), _x(G, T, 9)
    _, tp = _pair(w)
    _, ids, _ = tmoe.route(tp, torch.from_numpy(x), E, 2)
    C = tmoe.capacity(0.5, 2, T, E)
    counts = np.stack([np.bincount(ids[g].reshape(-1).numpy(), minlength=E) for g in range(G)])
    with tmoe.count_drops() as c:
        tmoe.moe_forward(tp, torch.from_numpy(x), num_experts=E, top_k=2, capacity_factor=0.5)
        tmoe.moe_forward(tp, torch.from_numpy(x), num_experts=E, top_k=2, capacity_factor=float(E))
    assert c.calls == 2 and c.assigned == 2 * G * T * 2
    assert int(c.dropped) == int(np.maximum(counts - C, 0).sum()) > 0
    assert np.array_equal(c.load.numpy(), 2 * counts.sum(axis=0))
    assert tmoe._COUNTER is None
