"""SSD300 trained over a mesh: ``train_ssd(mesh=)`` data parallel on a
(4,) mesh and ``train_ssd(tp="megatron")`` on a (2, 2) data × model mesh
by four gloo ranks (``torch_dist_scenarios``), against the JAX package's
``train_ssd`` on meshes of the same shapes, from the same weights (4
classes, fp32, one step of 4 images whose positives fall unevenly over
the ranks: one image has no gt at all).  The merged validation of 4
images (one a rank) equals the one-process validation's mAP.

Tolerances: the loss 1e-5 relative (data parallel) and 1e-4 (tensor
parallel, the reference's rtol); the parameters after the step, as one
vector, within 1e-4 relative L2 (test_torch_ssd_train.py holds a one-
device SSD300 step to the reference within 1e-4 a parameter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.core.module import Model as JaxModel
from analytics_zoo_tpu.models import SSDVgg as JaxSSD
from analytics_zoo_tpu.parallel import create_mesh
from analytics_zoo_tpu.parallel import train as jax_train
from analytics_zoo_tpu.pipelines import ssd as jssd
from analytics_zoo_tpu_torch.models.ssd import SSDVgg
from analytics_zoo_tpu_torch.parallel import validate
from analytics_zoo_tpu_torch.pipelines import ssd as pipe
from analytics_zoo_tpu_torch.utils import convert

WORLD = 4
MODES = {"dp": ((WORLD,), ("data",), None),
         "megatron": ((2, 2), ("data", "model"), "megatron")}
RTOL = {"dp": 1e-5, "megatron": 1e-4}
PARAM_RTOL = 1e-4


def _jax_params():
    """numpy-seeded flax params (no forward needed to build them)."""
    shapes = jax.eval_shape(JaxSSD(num_classes=4, resolution=300).init,
                            jax.random.PRNGKey(0),
                            jnp.zeros((1, 300, 300, 3), jnp.float32))
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        elif path[-1].key == "bias":
            v = np.zeros(leaf.shape)
        else:
            v = np.full(leaf.shape, 20.0)
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


def _batch(seed, B=4, G=3):
    rng = np.random.RandomState(seed)
    lo = rng.uniform(0, 0.6, (B, G, 2))
    wh = rng.uniform(0.1, 0.4, (B, G, 2))
    mask = np.ones((B, G), np.float32)
    mask[1, 1:] = 0
    mask[2] = 0
    return {"input": rng.randn(B, 300, 300, 3).astype(np.float32),
            "target": {"bboxes": np.concatenate([lo, lo + wh], -1)
                       .astype(np.float32),
                       "labels": rng.randint(1, 4, (B, G)).astype(np.int32),
                       "difficult": np.zeros((B, G), np.float32),
                       "mask": mask}}


@pytest.fixture(scope="module")
def weights():
    params = _jax_params()
    net = SSDVgg(4, 300, device="cpu")
    return params, {k: v.numpy() for k, v in
                    convert.ssd_params_from_jax(params, net).items()}


@pytest.fixture(scope="module")
def ranks(weights):
    """The ranks' runs, started before the JAX side and awaited after."""
    _, w = weights
    return sc.spawn_async(WORLD, {
        k: ("ssd_train", dict(weights=w, train=[_batch(1)],
                              val=[_batch(2)] if k == "dp" else None,
                              shape=shape, axes=axes, tp=tp))
        for k, (shape, axes, tp) in MODES.items()})


class _Losses:
    def __init__(self):
        self.values = []

    def add_scalar(self, tag, value, step):
        if tag == "Loss":
            self.values.append(float(value))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_ssd_over_a_mesh_matches_jax(weights, ranks, mode,
                                           monkeypatch):
    params, _ = weights
    shape, axes, tp = MODES[mode]
    model = JaxModel(JaxSSD(num_classes=4, resolution=300))
    model.variables = {"params": params}
    seen = []
    base = jax_train.Optimizer.optimize

    def optimize(self):
        self.train_summary = _Losses()
        seen.append(self)
        return base(self)

    monkeypatch.setattr(jax_train.Optimizer, "optimize", optimize)
    mesh = create_mesh(shape, axis_names=axes,
                       devices=jax.devices()[:WORLD])
    jssd.train_ssd([_batch(1)], None, jssd.TrainParams(
        max_epoch=1, n_classes=4, compute_dtype=None, prefetch=0),
        model=model, mesh=mesh, tp=tp)
    (opt,) = seen
    want_state = jax.device_get(opt._last_state.params)
    got = [r[mode] for r in ranks.result()]
    assert opt.train_summary.values and len(got[0]["losses"]) == 1
    for r in got:
        assert r["losses"] == got[0]["losses"]
    np.testing.assert_allclose(got[0]["losses"], opt.train_summary.values,
                               rtol=RTOL[mode])
    state = convert.state_dict_to_flax(
        {k: torch.from_numpy(v) for k, v in got[0]["state"].items()},
        {"params": want_state})["params"]
    flat = convert.flatten_params(want_state)
    num = sum(float(np.sum((state[k] - np.asarray(v)) ** 2))
              for k, v in flat.items())
    den = sum(float(np.sum(np.asarray(v) ** 2)) for v in flat.values())
    assert (num / den) ** 0.5 <= PARAM_RTOL


def test_merged_validation_equals_one_process(weights, ranks):
    """Each rank validated its one image through the detection output;
    the ranks' results merged in rank order give every rank the mAP of
    the one-process validation of the same trained weights."""
    got = [r["dp"] for r in ranks.result()]
    model = SSDVgg(4, 300, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in got[0]["state"].items()})
    model.eval()
    (want,) = validate(model, [_batch(2)], [pipe.SSDMeanAveragePrecision(
        n_classes=4, resolution=300)])
    for r in got:
        (score,) = [v for k, v in r["val"][-1].items() if k != "iteration"]
        np.testing.assert_allclose(score, want.result(), atol=1e-6)
