"""Gradients of the port's recurrences against the JAX package, on the
CPU: K4's plain version and autograd through ``_Persistent`` (K3 saving
its carries forward, K4 backward) against the JAX transposed backward
kernel (Pallas, interpret mode) and ``_scan_reference``'s vjp, K3's saved
carries against the JAX ``save_residuals`` output, and the reverse and
bidirectional layers against the blocked engine.

Inputs come from seeded numpy; the JAX Pallas kernel runs in interpret
mode, so every case that reaches it keeps T ≤ 16.  Tolerance: 1e-5
absolute in fp32 (the same float ops in another summation order; the
measured differences are ≤ 1.5e-6); the layers' gradients of a sum of
squares reach ~50, so there 1e-6 relative as well (measured ≤ 2.2e-7).
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
    flatten_params, flax_variables_to_state_dict, state_dict_to_flax)

torch.set_num_threads(2)

ATOL = 1e-5
RTOL_LAYERS = 1e-6
GRADS = ("d_pre", "d_w", "d_b", "d_h0")


def _case(cell, T=7, masked=True, seed=0):
    """The inputs and cotangents of the JAX package's ``_kernel_grad_case``
    (``tests/test_pallas_rnn.py``): B=3, H=6, ragged or uniform."""
    k, C = pallas_rnn.CELL_GATES[cell], pallas_rnn.CELL_CARRY[cell]
    B, H = 3, 6
    rng = np.random.RandomState(seed)
    pre = rng.randn(B, T, k * H).astype(np.float32) * 0.3
    w = rng.randn(H, k * H).astype(np.float32) * 0.3
    b = rng.randn(k * H).astype(np.float32) * 0.1
    h0 = rng.randn(C, B, H).astype(np.float32) * 0.2
    n = (np.array([T, max(T - 4, 1), 2], np.int32) if masked
         else np.full((B,), T, np.int32))
    gy = rng.randn(B, T, H).astype(np.float32)
    gc = rng.randn(C, B, H).astype(np.float32)
    return (pre, w, b, h0, n), gy, gc


def _jax_grads(cell, inputs, gy, gc, time_block, backward):
    pre, w, b, h0, n = (jnp.asarray(a) for a in inputs)

    def loss(pre, w, b, h0):
        ys, cf = jax_pallas_rnn.persistent_rnn(
            pre, w, b, h0, n, cell=cell, activation="tanh",
            time_block=time_block, interpret=True, backward=backward)
        return jnp.sum(ys * gy) + jnp.sum(cf * gc)

    return jax.grad(loss, argnums=(0, 1, 2, 3))(pre, w, b, h0)


def _torch_grads(cell, inputs, gy, gc, time_block, backward):
    """Autograd through the port's ``persistent_rnn``."""
    pre, w, b, h0 = (torch.from_numpy(a).requires_grad_()
                     for a in inputs[:4])
    ys, cf = pallas_rnn.persistent_rnn(
        pre, w, b, h0, torch.from_numpy(inputs[4]), cell=cell,
        activation="tanh", time_block=time_block, backward=backward)
    loss = (ys * torch.from_numpy(gy)).sum() + (cf * torch.from_numpy(gc)
                                                ).sum()
    return torch.autograd.grad(loss, (pre, w, b, h0))


def _plain_grads(cell, inputs, gy, gc, time_block):
    """K4's plain version called directly on K3's plain saved carries."""
    pre, w, b, h0, n = (torch.from_numpy(a) for a in inputs)
    cfg = pallas_rnn.RnnKernelConfig(cell, "tanh", time_block)
    _, _, cs = pallas_rnn.persistent_rnn_plain(cfg, pre, w, b, h0, n,
                                               save_residuals=True)
    return pallas_rnn.persistent_rnn_bwd_plain(
        cfg, pre, w, b, n, cs, torch.from_numpy(gy), torch.from_numpy(gc))


def _assert_grads(got, want, what):
    for name, a, r in zip(GRADS, got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(r),
                                   atol=ATOL, err_msg=f"{what} {name}")


@pytest.mark.parametrize(
    "cell,masked,T,time_block",
    [("vanilla", True, 7, 4), ("gru", True, 7, 4), ("lstm", True, 7, 4),
     ("vanilla", False, 7, 4), ("gru", True, 11, 3)],
    ids=["vanilla-ragged", "gru-ragged", "lstm-ragged", "vanilla-uniform",
         "gru-T11-tb3"])
def test_k4_matches_jax_kernel_and_scan_vjp(cell, masked, T, time_block):
    """d_pre, d_w, d_b and d_h0 of K4's plain version, of autograd through
    ``_Persistent`` and of ``backward="scan"``, each against the JAX
    transposed kernel and ``_scan_reference``'s vjp.  T=11 at
    ``time_block=3`` walks 4 reversed blocks, the last one short: dW and
    db must carry across all of them."""
    inputs, gy, gc = _case(cell, T=T, masked=masked)
    want = {bw: _jax_grads(cell, inputs, gy, gc, time_block, bw)
            for bw in ("pallas", "scan")}
    got = {"plain": _plain_grads(cell, inputs, gy, gc, time_block),
           "autograd": _torch_grads(cell, inputs, gy, gc, time_block,
                                    "pallas"),
           "scan": _torch_grads(cell, inputs, gy, gc, time_block, "scan")}
    for g_name, g in got.items():
        for w_name, w in want.items():
            _assert_grads(g, w, f"{cell} {g_name} vs jax {w_name}")


@pytest.mark.parametrize("cell,T,time_block", [
    ("vanilla", 7, 4), ("gru", 11, 3), ("lstm", 7, 2)])
def test_saved_carries_equal_jax_residuals(cell, T, time_block):
    """K3's ``cs`` (plain version) against the JAX kernel's
    ``save_residuals`` output, un-padded: the carry at the start of every
    block, frozen past a row's length."""
    inputs, _, _ = _case(cell, T=T)
    cfg = pallas_rnn.RnnKernelConfig(cell, "tanh", time_block)
    ys, cf, cs = pallas_rnn.persistent_rnn_plain(
        cfg, *(torch.from_numpy(a) for a in inputs), save_residuals=True)
    j_cfg = jax_pallas_rnn.RnnKernelConfig(cell, "tanh", time_block, True)
    j_ys, j_cf, j_cs = jax_pallas_rnn._run_kernel(
        j_cfg, *(jnp.asarray(a) for a in inputs), save_residuals=True)
    B, H = inputs[3].shape[1:]
    assert cs.shape == (-(-T // time_block),) + inputs[3].shape
    np.testing.assert_allclose(cs.numpy(), np.asarray(j_cs)[:, :, :B, :H],
                               atol=ATOL)
    np.testing.assert_allclose(ys.numpy(), np.asarray(j_ys), atol=ATOL)
    # without autograd the forward returns no carries
    assert len(pallas_rnn.persistent_rnn_fwd(
        cfg, *(torch.from_numpy(a) for a in inputs))) == 2


def test_bf16_weight_gradient_comes_back_in_bf16():
    """``d_w`` in ``w``'s type (the reference's out_shape at ``:484``): a
    bf16 copy of an fp32 master passes its gradient back through the cast;
    within bf16's rounding of the scan reference's gradient."""
    inputs, gy, gc = _case("vanilla", T=7)
    master = torch.from_numpy(inputs[1]).requires_grad_()
    wb = master.to(torch.bfloat16)
    wb.retain_grad()
    ys, cf = pallas_rnn.persistent_rnn(
        torch.from_numpy(inputs[0]), wb, torch.from_numpy(inputs[2]),
        torch.from_numpy(inputs[3]), torch.from_numpy(inputs[4]),
        activation="tanh", time_block=4)
    ((ys * torch.from_numpy(gy)).sum() + (cf * torch.from_numpy(gc)).sum()
     ).backward()
    assert wb.grad.dtype == torch.bfloat16
    assert master.grad.dtype == torch.float32
    cfg = jax_pallas_rnn.RnnKernelConfig("vanilla", "tanh", 4, True)

    def loss(w):
        ys, cf = jax_pallas_rnn._scan_reference(
            cfg, jnp.asarray(inputs[0]), w, jnp.asarray(inputs[2]),
            jnp.asarray(inputs[3]), jnp.asarray(inputs[4]))
        return jnp.sum(ys * gy) + jnp.sum(cf * gc)

    want = jax.grad(loss)(jnp.asarray(inputs[1], jnp.bfloat16))
    np.testing.assert_allclose(master.grad.numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


def test_backward_options_are_checked():
    args = [torch.zeros(2, 3, 4), torch.zeros(4, 4), torch.zeros(4),
            torch.zeros(1, 2, 4)]
    with pytest.raises(ValueError, match="backward"):
        pallas_rnn.persistent_rnn(*args, backward="adjoint")
    with pytest.raises(ValueError, match="time_block"):
        pallas_rnn.persistent_rnn(*args, time_block=0)


# -- layers: gradients through the reverse gather and both directions -----

def _x(B=3, T=9, D=4, seed=0):
    return np.random.RandomState(seed).randn(B, T, D).astype(np.float32)


def _layer_grads(net, x, n):
    xt = torch.from_numpy(x).requires_grad_()
    loss = (net(xt, n_frames=torch.from_numpy(n)) ** 2).sum()
    names, params = zip(*net.named_parameters())
    grads = torch.autograd.grad(loss, (xt,) + params)
    return grads[0], dict(zip(names, grads[1:]))


def _assert_layer_grads(got, want):
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=ATOL,
                               rtol=RTOL_LAYERS)
    assert got[1].keys() == want[1].keys()
    for k in want[1]:
        np.testing.assert_allclose(got[1][k].numpy(), want[1][k].numpy(),
                                   atol=ATOL, rtol=RTOL_LAYERS, err_msg=k)


@pytest.mark.parametrize("name", ["rnn", "gru", "lstm"])
def test_reverse_grads_match_blocked(name):
    """Gradients through the reverse prefix gather (what a BiRecurrent's
    backward direction runs): the "pallas" engine (K3/K4 plain versions)
    against the blocked loop, with the same weights."""
    cell = {"rnn": lambda: rnn.RnnCell(6, input_size=4),
            "gru": lambda: rnn.GRUCell(6, 4),
            "lstm": lambda: rnn.LSTMCell(6, 4)}[name]()
    x = _x()
    n = np.array([7, 5, 2], np.int32)
    blocked = rnn.Recurrent(cell, reverse=True, engine="blocked")
    pallas = rnn.Recurrent(cell, reverse=True, engine="pallas")
    pallas.load_state_dict(blocked.state_dict())
    _assert_layer_grads(_layer_grads(pallas, x, n),
                        _layer_grads(blocked, x, n))


def test_reverse_grads_match_jax_blocked():
    """The same gradients against the JAX package's blocked engine, the
    port's mapped back to flax's names and layouts."""
    x = _x()
    n = np.array([7, 5, 2], np.int32)
    jnet = jax_rnn.Recurrent(cell=jax_rnn.RnnCell(hidden_size=6),
                             reverse=True, engine="blocked", block_size=4)
    pnet = rnn.Recurrent(rnn.RnnCell(6, input_size=4), reverse=True,
                         engine="pallas")
    variables = jnet.init(jax.random.PRNGKey(3), jnp.asarray(x))
    pnet.load_state_dict(flax_variables_to_state_dict(variables, pnet))
    want = jax.grad(lambda v: jnp.sum(jnet.apply(
        v, jnp.asarray(x), n_frames=n) ** 2))(variables)["params"]
    want = flatten_params(want)
    got = state_dict_to_flax(_layer_grads(pnet, x, n)[1], variables)
    assert got["params"].keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got["params"][k], want[k], atol=ATOL,
                                   rtol=RTOL_LAYERS, err_msg=k)


@pytest.mark.parametrize("merge", ["sum", "concat"])
def test_birecurrent_padded_row_grads_match_blocked(merge):
    """Bidirectional ragged gradients on the "pallas" engine: the padded
    rows' gradients (input and weights) must match the blocked loop's —
    the masked steps pass the carry's cotangent through."""
    x = _x(B=3, T=9, D=6, seed=1)
    n = np.array([7, 5, 2], np.int32)
    cell = rnn.RnnCell(6, identity_input=True, activation="clipped_relu")
    blocked = rnn.BiRecurrent(cell, merge=merge, engine="blocked")
    pallas = rnn.BiRecurrent(cell, merge=merge, engine="pallas")
    pallas.load_state_dict(blocked.state_dict())
    got = _layer_grads(pallas, x, n)
    want = _layer_grads(blocked, x, n)
    _assert_layer_grads(got, want)
    # the padded frames of every row get no gradient
    pad = np.arange(9)[None, :] >= n[:, None]
    assert not got[0].numpy()[pad].any()
