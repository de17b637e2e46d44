"""Expert (MoE) parallelism of the port (``parallel/expert.py``) against
the JAX package's.

In this process: ``route_top1``'s dispatch and scale EQUAL to the
reference's (random routing, every token to one expert past the
capacity, and 512 bf16 tokens to one expert, where a bf16 count would
repeat slots), and ``moe_apply_dense`` within 1e-5 (dropped tokens
exactly zero).  One group of four spawned ranks (``torch_dist_scenarios``,
no JAX) runs ``moe_apply_expert_parallel`` on a (4,) ``("expert",)`` mesh
with 4 experts, each rank its 16 tokens, at a capacity that drops some:
the outputs within 1e-5 of the reference's on 4 virtual devices, and the
gradients (tokens, the experts' stack and the gate, the latter two
summed over the ranks) within 1e-5 of JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.parallel import expert as jexp
from analytics_zoo_tpu_torch.parallel import expert

WORLD = 4
TOL = 1e-5
D, H, E, N = 8, 16, 4, 64


def _jax_expert(p, a):
    return jax.nn.gelu(a @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _port_expert(p, a):
    return torch.nn.functional.gelu(
        a @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] + p["b2"]


@functools.lru_cache(maxsize=None)
def _moe(seed=0):
    r = np.random.RandomState(seed)
    stacked = {"w1": (r.randn(E, D, H) / np.sqrt(D)).astype(np.float32),
               "b1": (r.randn(E, H) * 0.1).astype(np.float32),
               "w2": (r.randn(E, H, D) / np.sqrt(H)).astype(np.float32),
               "b2": (r.randn(E, D) * 0.1).astype(np.float32)}
    gate = (r.randn(D, E) * 0.5).astype(np.float32)
    x = r.randn(N, D).astype(np.float32)
    cot = r.randn(N, D).astype(np.float32)
    return stacked, gate, x, cot


CAPACITY = 3          # per (sender, expert): 16 tokens a rank, some drop


@pytest.fixture(scope="module")
def ranks():
    stacked, gate, x, cot = _moe()
    return sc.spawn_async(WORLD, {"ep": ("moe_ep", dict(
        stacked=stacked, gate=gate, x=x, cot=cot, capacity=CAPACITY))})


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _route_both(x, gk, capacity, dtype=np.float32):
    jd, js = jexp.route_top1(jnp.asarray(x, dtype), jnp.asarray(gk, dtype),
                             capacity)
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    td, ts = expert.route_top1(torch.tensor(np.asarray(x, np.float32)).to(tdt),
                               torch.tensor(np.asarray(gk, np.float32))
                               .to(tdt), capacity)
    return ((np.asarray(jd, np.float32), np.asarray(js, np.float32)),
            (td.float().numpy(), ts.float().numpy()))


def test_route_top1_equals_reference():
    """Random routing at a capacity that drops, every token to one expert
    (only ``capacity`` survive, the rest scale 0), and 512 bf16 tokens to
    one expert at capacity 512 (int32 slot counts keep every slot
    unique): dispatch and scale EQUAL to the reference's."""
    stacked, gate, x, _ = _moe()
    (jd, js), (td, ts) = _route_both(x, gate, 10)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_allclose(ts, js, rtol=1e-6)
    assert jd.sum() < N                       # the capacity dropped some
    one = np.zeros((4, 3), np.float32)
    one[:, 1] = 1.0
    (jd, js), (td, ts) = _route_both(np.ones((6, 4), np.float32), one, 2)
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(ts, js)
    assert td.sum() == 2 and (ts > 0).sum() == 2
    gk = np.zeros((8, 8), np.float32)
    gk[:, 2] = 1.0
    (jd, js), (td, ts) = _route_both(np.ones((512, 8), np.float32), gk, 512,
                                     jnp.bfloat16)
    np.testing.assert_array_equal(td, jd)
    assert td.sum(0).max() <= 1 and td.sum() == 512


def test_moe_apply_dense_matches_reference():
    """The dense path at a capacity that drops: within 1e-5 of the
    reference's, the dropped tokens' rows exactly zero; an expert count
    the gate does not route to raises."""
    stacked, gate, x, _ = _moe()
    want = np.asarray(jexp.moe_apply_dense(
        _jax_expert, jax.tree_util.tree_map(jnp.asarray, stacked),
        jnp.asarray(gate), jnp.asarray(x), capacity=10))
    got = expert.moe_apply_dense(_port_expert, _t(stacked),
                                 torch.from_numpy(gate), torch.from_numpy(x),
                                 capacity=10).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    dropped = (want == 0).all(-1)
    assert dropped.any() and (got[dropped] == 0).all()
    with pytest.raises(ValueError, match="experts"):
        expert.moe_apply_dense(_port_expert, _t(stacked),
                               torch.zeros(D, 2), torch.from_numpy(x))
    with pytest.raises(ValueError, match="one expert per device"):
        expert.moe_apply_expert_parallel(
            _port_expert, _t(stacked), torch.zeros(D, 2),
            torch.from_numpy(x), sc.StubMesh({"expert": 4}))


def test_expert_parallel_matches_reference(ranks):
    """Four experts one a rank, two all-to-all exchanges, the capacity
    per (sender, expert) pair: each rank's outputs within 1e-5 of the
    reference's ``moe_apply_expert_parallel`` on 4 devices, and the
    gradients of ``sum(y · cot)`` (the rank's tokens; the stack and the
    gate whole on every rank) within 1e-5 of JAX's."""
    stacked, gate, x, cot = _moe()
    mesh = create_mesh((4,), axis_names=("expert",),
                       devices=jax.devices()[:4])

    def f(p, g, a):
        y = jexp.moe_apply_expert_parallel(_jax_expert, p, g, a, mesh,
                                           capacity=CAPACITY)
        return jnp.sum(y * cot), y

    (_, y), (g_p, g_g, g_x) = jax.jit(jax.value_and_grad(
        f, (0, 1, 2), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, stacked), jnp.asarray(gate),
        jnp.asarray(x))
    y, g_x = np.asarray(y), np.asarray(g_x)
    per = N // WORLD
    assert (y == 0).all(-1).any()             # some tokens dropped
    for r in ranks.result():
        got = r["ep"]
        rows = slice(got["idx"] * per, (got["idx"] + 1) * per)
        np.testing.assert_allclose(got["out"], y[rows], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["g_x"], g_x[rows], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got["g_gate"], np.asarray(g_g), rtol=TOL,
                                   atol=TOL)
        for k, v in g_p.items():
            np.testing.assert_allclose(got["g_params"][k], np.asarray(v),
                                       rtol=TOL, atol=TOL, err_msg=k)
