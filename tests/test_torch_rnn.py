"""Parity of the port's recurrent layers and K3's plain version with the
JAX package, on the CPU.

Inputs and weights come from seeded numpy (weights through the flax
tree, bridged by name).  The JAX Pallas kernel runs in interpret mode,
so every case that reaches it keeps T ≤ 16.  Tolerance: 1e-5 absolute
in fp32 (the same float ops in another summation order, at widths of
4–8); the port is held against the blocked engine and ``_scan_reference``,
not the legacy per-step path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core import rnn as jax_rnn
from analytics_zoo_tpu.ops import pallas_rnn as jax_pallas_rnn
from analytics_zoo_tpu_torch.core import rnn
from analytics_zoo_tpu_torch.ops import pallas_rnn
from analytics_zoo_tpu_torch.utils.convert import (
    flax_variables_to_state_dict)

torch.set_num_threads(2)

ATOL = 1e-5

KERNEL_CASES = [
    # cell, activation, B, T, H
    ("vanilla", "relu", 3, 11, 6),
    ("vanilla", "clipped_relu", 4, 9, 8),
    ("vanilla", "tanh", 3, 11, 6),
    ("gru", "relu", 3, 11, 6),
    ("lstm", "relu", 3, 11, 6),
]


def _kernel_inputs(seed, cell, B, T, H, masked):
    rng = np.random.RandomState(seed)
    k = pallas_rnn.CELL_GATES[cell]
    C = pallas_rnn.CELL_CARRY[cell]
    pre = rng.randn(B, T, k * H).astype(np.float32) * 2.0
    w = rng.randn(H, k * H).astype(np.float32) * 0.5
    b = rng.randn(k * H).astype(np.float32) * 0.1
    h0 = rng.randn(C, B, H).astype(np.float32) * 0.3
    n = (np.array([T, 5, 2, T + 4][:B], np.int32) if masked
         else np.full((B,), T, np.int32))
    return pre, w, b, h0, n


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cell,act,B,T,H", KERNEL_CASES)
def test_plain_matches_jax_kernel_and_scan_reference(cell, act, B, T, H,
                                                     masked):
    pre, w, b, h0, n = _kernel_inputs(1, cell, B, T, H, masked)
    ys, cf = pallas_rnn.persistent_rnn(
        *(torch.from_numpy(a) for a in (pre, w, b, h0, n)),
        cell=cell, activation=act)
    j_ys, j_cf = jax_pallas_rnn.persistent_rnn(
        *(jnp.asarray(a) for a in (pre, w, b, h0, n)), cell=cell,
        activation=act, interpret=True)
    cfg = jax_pallas_rnn.RnnKernelConfig(cell, act, 8, True)
    r_ys, r_cf = jax_pallas_rnn._scan_reference(
        cfg, *(jnp.asarray(a) for a in (pre, w, b, h0)),
        jnp.minimum(jnp.asarray(n), T))
    for want_ys, want_cf in ((j_ys, j_cf), (r_ys, r_cf)):
        np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys),
                                   atol=ATOL)
        np.testing.assert_allclose(cf.numpy(), np.asarray(want_cf),
                                   atol=ATOL)


def test_plain_bf16_weights_match_scan_reference():
    """bf16 weights: h is rounded to bf16 before each product and summed
    in fp32 on both sides; the outputs stay fp32."""
    pre, w, b, h0, n = _kernel_inputs(2, "vanilla", 3, 11, 6, True)
    wb = torch.from_numpy(w).to(torch.bfloat16)
    ys, cf = pallas_rnn.persistent_rnn(
        torch.from_numpy(pre), wb, torch.from_numpy(b), torch.from_numpy(h0),
        torch.from_numpy(n), cell="vanilla", activation="clipped_relu")
    cfg = jax_pallas_rnn.RnnKernelConfig("vanilla", "clipped_relu", 8, True)
    r_ys, r_cf = jax_pallas_rnn._scan_reference(
        cfg, jnp.asarray(pre), jnp.asarray(wb.float().numpy(), jnp.bfloat16),
        jnp.asarray(b), jnp.asarray(h0), jnp.minimum(jnp.asarray(n), 11))
    np.testing.assert_allclose(ys.numpy(), np.asarray(r_ys), atol=ATOL)
    np.testing.assert_allclose(cf.numpy(), np.asarray(r_cf), atol=ATOL)


def test_config_and_errors():
    assert pallas_rnn.CELL_GATES == jax_pallas_rnn.CELL_GATES
    assert pallas_rnn.CELL_CARRY == jax_pallas_rnn.CELL_CARRY
    pre = torch.zeros(2, 4, 4)
    args = (pre, torch.zeros(4, 4), torch.zeros(4), torch.zeros(1, 2, 4))
    with pytest.raises(ValueError, match="cell"):
        pallas_rnn.persistent_rnn(*args, cell="elman")
    with pytest.raises(ValueError, match="shapes"):
        pallas_rnn.persistent_rnn(*args, cell="gru")
    # autograd runs the persistent backward (K4's plain version here):
    # every differentiable input receives a gradient
    grads = [a.clone().requires_grad_() for a in args]
    ys, cf = pallas_rnn.persistent_rnn(*grads, activation="tanh")
    (ys.sum() + cf.sum()).backward()
    for a in grads:
        assert a.grad is not None and a.grad.shape == a.shape
        assert torch.isfinite(a.grad).all()


# -- layers ----------------------------------------------------------------

D_IN = 4


def _cells(name, H=6):
    """(JAX cell, port cell template) pairs of the same kind."""
    if name == "rnn":
        return jax_rnn.RnnCell(hidden_size=H), rnn.RnnCell(H, input_size=D_IN)
    if name == "rnn_identity":
        return (jax_rnn.RnnCell(hidden_size=H, identity_input=True,
                                activation="clipped_relu"),
                rnn.RnnCell(H, identity_input=True,
                            activation="clipped_relu"))
    if name == "gru":
        return jax_rnn.GRUCell(hidden_size=H), rnn.GRUCell(H, D_IN)
    return jax_rnn.LSTMCell(hidden_size=H), rnn.LSTMCell(H, D_IN)


def _x(name, B=3, T=9, H=6, seed=0):
    D = H if name == "rnn_identity" else D_IN
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _bridge(jax_net, port_net, x, **kw):
    variables = jax_net.init(jax.random.PRNGKey(3), jnp.asarray(x), **kw)
    port_net.load_state_dict(flax_variables_to_state_dict(variables,
                                                          port_net))
    return variables


def _close(a, b):
    if isinstance(b, (tuple, list)):
        for u, v in zip(a, b):
            _close(u, v)
        return
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=ATOL)


CELL_NAMES = ["rnn", "rnn_identity", "gru", "lstm"]


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", CELL_NAMES)
def test_recurrent_matches_jax_blocked(name, masked, reverse, engine):
    jcell, pcell = _cells(name)
    x = _x(name)
    n = np.array([9, 4, 1], np.int32) if masked else None
    jnet = jax_rnn.Recurrent(cell=jcell, reverse=reverse, engine="blocked",
                             block_size=4)
    pnet = rnn.Recurrent(pcell, reverse=reverse, engine=engine)
    variables = _bridge(jnet, pnet, x)
    want = jnet.apply(variables, jnp.asarray(x), n_frames=n)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x),
                   n_frames=None if n is None else torch.from_numpy(n))
    _close(got, want)


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
@pytest.mark.parametrize("merge", ["sum", "concat"])
@pytest.mark.parametrize("name", CELL_NAMES)
def test_birecurrent_ragged_matches_jax_blocked(name, merge, engine):
    """Ragged rows, n_frames past T included (clamped): the backward
    direction reverses each row's valid prefix only."""
    jcell, pcell = _cells(name)
    x = _x(name, B=4, T=8, seed=1)
    n = np.array([8, 5, 1, 12], np.int32)
    jnet = jax_rnn.BiRecurrent(cell=jcell, merge=merge, engine="blocked",
                               block_size=4)
    pnet = rnn.BiRecurrent(pcell, merge=merge, engine=engine)
    variables = _bridge(jnet, pnet, x)
    want = jnet.apply(variables, jnp.asarray(x), n_frames=n)
    with torch.no_grad():
        got = pnet(torch.from_numpy(x), n_frames=torch.from_numpy(n))
    _close(got, want)


@pytest.mark.parametrize("engine", ["blocked", "pallas"])
@pytest.mark.parametrize("name", CELL_NAMES)
def test_carry_in_and_out_match_jax(name, engine):
    jcell, pcell = _cells(name)
    x = _x(name, B=2, T=6, seed=2)
    rng = np.random.RandomState(5)
    h = rng.randn(2, 6).astype(np.float32) * 0.5
    carry_np = ((h, rng.randn(2, 6).astype(np.float32) * 0.5)
                if name == "lstm" else h)
    jnet = jax_rnn.Recurrent(cell=jcell, engine="blocked")
    pnet = rnn.Recurrent(pcell, engine=engine)
    variables = _bridge(jnet, pnet, x)
    j_carry = jax.tree_util.tree_map(jnp.asarray, carry_np)
    want_ys, want_c = jnet.apply(variables, jnp.asarray(x), carry0=j_carry,
                                 return_carry=True)
    p_carry = (tuple(torch.from_numpy(c) for c in carry_np)
               if name == "lstm" else torch.from_numpy(carry_np))
    with torch.no_grad():
        got_ys, got_c = pnet(torch.from_numpy(x), carry0=p_carry,
                             return_carry=True)
    _close(got_ys, want_ys)
    _close(got_c, want_c)


def test_stacked_params_match_jax():
    for name in ("rnn", "gru", "lstm"):
        jcell, pcell = _cells(name)
        x = _x(name)
        jnet = jax_rnn.Recurrent(cell=jcell, engine="blocked")
        pnet = rnn.Recurrent(pcell)
        variables = _bridge(jnet, pnet, x)
        kind = rnn._pallas_cell_kind(pnet.body)
        jw, jb = jax_rnn._stack_recurrent_params(
            kind, variables["params"]["body"])
        w, b = rnn._stack_recurrent_params(kind, pnet.body)
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jw))
        np.testing.assert_array_equal(b.detach().numpy(), np.asarray(jb))


def test_engines_and_fresh_weights():
    cell = rnn.RnnCell(6, input_size=D_IN)
    with pytest.raises(ValueError, match="engine"):
        rnn.Recurrent(cell, engine="warp")
    # the legacy per-step engine runs, without length masking
    with pytest.raises(ValueError, match="n_frames"):
        rnn.Recurrent(cell, engine="legacy")(torch.zeros(1, 2, D_IN),
                                             n_frames=torch.tensor([1]))
    assert rnn.Recurrent(cell, engine="legacy")(
        torch.zeros(1, 2, D_IN)).shape == (1, 2, 6)
    bi = rnn.BiRecurrent(cell)
    assert not torch.equal(bi.fwd.body.h2h.weight, bi.bwd.body.h2h.weight)
    gen = [torch.Generator().manual_seed(0) for _ in range(2)]
    a, b = (rnn.Recurrent(cell, generator=g) for g in gen)
    assert torch.equal(a.body.h2h.weight, b.body.h2h.weight)
