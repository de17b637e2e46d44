"""DeepSpeech2's last training pieces on the port, against the JAX
package, on the CPU: the multiprocess ASR loader
(``load_asr_train_set(worker_processes=, param=)``) and the ``"legacy"``
recurrence engine.

The loader's batches from two forked workers equal ``worker_processes=0``'s
and the reference's, array for array (the same numpy featurize), fixed
and bucketed, for two epochs.  The legacy engine (the per-step body: the
cell's input projection and h2h product at every step) is held against
the reference's legacy scan (``_legacy_scan``) in the forward and in the
input and weight gradients, for every cell kind and both directions,
within ``ATOL`` (1e-5: the same fp32 ops in another order, at width 6),
and against the port's own "blocked" engine.  The reference's test that
compares its "legacy" with its "blocked" fails (ROADMAP.md Queue 3), so
that comparison is not the oracle here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.core import rnn as jax_rnn
from analytics_zoo_tpu.pipelines import deepspeech2 as jax_pipe
from analytics_zoo_tpu.pipelines.ssd import (
    PreProcessParam as JaxPreProcessParam)
from analytics_zoo_tpu_torch.core import rnn
from analytics_zoo_tpu_torch.data.parallel import ParallelLoader
from analytics_zoo_tpu_torch.models.deepspeech2 import DeepSpeech2
from analytics_zoo_tpu_torch.pipelines import deepspeech2 as pipe
from analytics_zoo_tpu_torch.pipelines.ssd import PreProcessParam
from test_torch_ds2_train import _assert_batches_equal, _waves
from test_torch_rnn import CELL_NAMES, _bridge, _cells, _x

torch.set_num_threads(2)

ATOL = 1e-5


# -- the multiprocess loader -------------------------------------------------

@pytest.mark.parametrize("bucketed", [False, True])
def test_worker_processes_equal_serial_and_reference(bucketed):
    samples, labels, lengths = _waves(20, 4)
    kw = (dict(sample_lengths=lengths, bucket_edges=[30, 45, 60])
          if bucketed else dict(utt_length=50))
    forked = pipe.load_asr_train_set(samples, labels, batch_size=3, seed=7,
                                     worker_processes=2, **kw)
    assert isinstance(forked, ParallelLoader) and forked.num_workers == 2
    serial = pipe.load_asr_train_set(samples, labels, batch_size=3, seed=7,
                                     **kw)
    ref = jax_pipe.load_asr_train_set(samples, labels, batch_size=3,
                                      seed=7, worker_processes=2, **kw)
    for _ in range(2):                  # the second epoch reshuffled
        got = list(forked)
        _assert_batches_equal(got, list(serial))
        _assert_batches_equal(got, list(ref))


def test_param_supplies_the_loader_settings():
    """``param`` (a ``PreProcessParam``) sets the batch size, the worker
    processes, the loader seed and the bucket edges, as the reference's."""
    samples, labels, lengths = _waves(16, 6)
    got = pipe.load_asr_train_set(
        samples, labels, sample_lengths=lengths,
        param=PreProcessParam(batch_size=4, worker_processes=2,
                              loader_seed=5, bucket_edges=[40, 60]))
    want = jax_pipe.load_asr_train_set(
        samples, labels, sample_lengths=lengths,
        param=JaxPreProcessParam(batch_size=4, worker_processes=2,
                                 loader_seed=5, bucket_edges=[40, 60]))
    got_b, want_b = list(got), list(want)
    assert all(b["labels"].shape[0] == 4 for b in got_b)
    _assert_batches_equal(got_b, want_b)


# -- the legacy engine ------------------------------------------------------

def _grads(pnet, x):
    xt = torch.from_numpy(x).requires_grad_()
    out = pnet(xt)
    g = np.random.RandomState(9).randn(*out.shape).astype(np.float32)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach(), xt.grad, {k: p.grad for k, p in
                                   pnet.named_parameters()}, g


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", CELL_NAMES)
def test_legacy_matches_reference_legacy_scan(name, reverse):
    """Forward, input gradient and every weight gradient of the port's
    legacy engine against the reference's ``_legacy_scan``."""
    from analytics_zoo_tpu_torch.utils.convert import state_dict_to_flax

    jcell, pcell = _cells(name)
    x = _x(name, seed=4)
    jnet = jax_rnn.Recurrent(cell=jcell, reverse=reverse, engine="legacy")
    pnet = rnn.Recurrent(pcell, reverse=reverse, engine="legacy")
    variables = _bridge(jnet, pnet, x)
    out, gx, gw, g = _grads(pnet, x)

    def loss(params, x):
        return jnp.sum(jnet.apply({"params": params}, x) * jnp.asarray(g))

    want = jnet.apply(variables, jnp.asarray(x))
    j_gw, j_gx = jax.grad(loss, argnums=(0, 1))(variables["params"],
                                                jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(gx.numpy(), np.asarray(j_gx), atol=ATOL)
    got_gw = state_dict_to_flax(gw, variables)["params"]
    from analytics_zoo_tpu_torch.utils.convert import flatten_params
    want_gw = flatten_params(j_gw)
    assert set(got_gw) == set(want_gw)
    for k, v in want_gw.items():
        np.testing.assert_allclose(got_gw[k], v, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("name", CELL_NAMES)
def test_legacy_matches_port_blocked(name, reverse):
    """The same parameters through "legacy" and "blocked": outputs, the
    final carry and the gradients within ``ATOL``."""
    _jcell, pcell = _cells(name)
    x = _x(name, seed=5)
    legacy = rnn.Recurrent(pcell, reverse=reverse, engine="legacy",
                           generator=torch.Generator().manual_seed(1))
    blocked = rnn.Recurrent(pcell, reverse=reverse, engine="blocked",
                            generator=torch.Generator().manual_seed(1))
    blocked.load_state_dict(legacy.state_dict())
    with torch.no_grad():
        a, ca = legacy(torch.from_numpy(x), return_carry=True)
        b, cb = blocked(torch.from_numpy(x), return_carry=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=ATOL)
    for u, v in zip(ca if isinstance(ca, tuple) else (ca,),
                    cb if isinstance(cb, tuple) else (cb,)):
        np.testing.assert_allclose(u.numpy(), v.numpy(), atol=ATOL)
    (_, gx_a, gw_a, _), (_, gx_b, gw_b, _) = (_grads(n, x)
                                              for n in (legacy, blocked))
    np.testing.assert_allclose(gx_a.numpy(), gx_b.numpy(), atol=ATOL)
    for k in gw_a:
        np.testing.assert_allclose(gw_a[k].numpy(), gw_b[k].numpy(),
                                   atol=ATOL, err_msg=k)


def test_legacy_refuses_n_frames_as_the_reference():
    jcell, pcell = _cells("rnn")
    x = _x("rnn")
    n = np.array([9, 4, 1], np.int32)
    jnet = jax_rnn.Recurrent(cell=jcell, engine="legacy")
    variables = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x))
    with pytest.raises(ValueError, match="n_frames") as want:
        jnet.apply(variables, jnp.asarray(x), n_frames=n)
    with pytest.raises(ValueError, match="n_frames") as got:
        rnn.Recurrent(pcell, engine="legacy")(torch.from_numpy(x),
                                              n_frames=torch.from_numpy(n))
    assert type(got.value) is type(want.value) is ValueError
    # the DS2 model refuses it too, and serves the engine without it
    model = DeepSpeech2(hidden=8, n_rnn_layers=1, rnn_engine="legacy",
                        device="cpu")
    feats = torch.zeros(2, 20, 13)
    with pytest.raises(ValueError, match="n_frames"):
        model(feats, n_frames=torch.tensor([20, 10]))
    j_model = jax_pipe.make_ds2_model(hidden=8, n_rnn_layers=1,
                                      rnn_engine="legacy", utt_length=20)
    with pytest.raises(ValueError, match="n_frames"):
        j_model.module.apply(j_model.variables, jnp.zeros((2, 20, 13)),
                             n_frames=jnp.asarray([20, 10]))
    assert model(feats).shape == (2, 10, 29)


def test_ds2_legacy_forward_matches_blocked():
    """A DS2 built with ``rnn_engine="legacy"`` gives the blocked model's
    log-probs on the same weights (the A/B baseline)."""
    legacy = DeepSpeech2(hidden=16, n_rnn_layers=2, rnn_engine="legacy",
                         device="cpu", seed=3)
    blocked = DeepSpeech2(hidden=16, n_rnn_layers=2, rnn_engine="blocked",
                          device="cpu", seed=3)
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 24, 13).astype(
        np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(legacy(x).numpy(), blocked(x).numpy(),
                                   atol=ATOL)
