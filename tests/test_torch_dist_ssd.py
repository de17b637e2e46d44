"""SSD300 trained over a mesh: ``train_ssd(mesh=)`` data parallel on a
(4,) mesh, ``train_ssd(tp="megatron")`` and ``train_ssd(tp="spatial")``
on a (2, 2) data × model mesh by four gloo ranks
(``torch_dist_scenarios``), against the JAX package's ``train_ssd`` on
meshes of the same shapes, from the same weights (4 classes, fp32, one
step of 4 images whose positives fall unevenly over the ranks: one image
has no gt at all).  The merged validation of 4 images (one a rank)
equals the one-process validation's mAP; under ``tp="spatial"`` each
data coordinate's two images count once.

The spatial forward alone (the image rows over ``model``: each layer
fetches its halo rows, the heads gathered) against the unsharded port,
over ``model`` = 2 (blocks of 150; pool2's windows straddle row 75, fc6
fetches 6 rows) and 4 (blocks of 75; conv9_2's one row leaves three
ranks an empty block): in fp32 the forward's outputs within 1e-5 of their
largest, in fp64 the outputs and every parameter's gradient within 1e-10
relative
(fp64, where a max pool's near-tie cannot flip between the two runs'
rounding).

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
         "megatron": ((2, 2), ("data", "model"), "megatron"),
         "spatial": ((2, 2), ("data", "model"), "spatial")}
RTOL = {"dp": 1e-5, "megatron": 1e-4, "spatial": 1e-4}
PARAM_RTOL = 1e-4
# (dtype, mesh shape) of the spatial forwards: model = 2 and 4
SPATIAL = {"f32_model4": (np.float32, (1, 4)),
           "f64_model2": (np.float64, (2, 2)),
           "f64_model4": (np.float64, (1, 4))}
SPATIAL_TOL = {np.float32: 1e-5, np.float64: 1e-10}


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


def _spatial_inputs(dtype, shape):
    rng = np.random.RandomState(3)
    B = shape[0]
    return (rng.randn(B, 300, 300, 3).astype(dtype),
            tuple(rng.randn(B, 8732, 4).astype(dtype) for _ in range(2)))


@pytest.fixture(scope="module")
def ranks(weights):
    """The ranks' runs, started before the JAX side and awaited after."""
    _, w = weights
    scenarios = {
        k: ("ssd_train", dict(weights=w, train=[_batch(1)],
                              val=[_batch(2)] if k != "megatron" else None,
                              shape=shape, axes=axes, tp=tp))
        for k, (shape, axes, tp) in MODES.items()}
    for k, (dtype, shape) in SPATIAL.items():
        x, cot = _spatial_inputs(dtype, shape)
        scenarios[k] = ("ssd_spatial_forward", dict(
            weights={n: v.astype(dtype) for n, v in w.items()}, x=x,
            cot=cot if dtype is np.float64 else None, shape=shape,
            axes=("data", "model")))
    return sc.spawn_async(WORLD, scenarios)


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


@pytest.mark.parametrize("mode", ["dp", "spatial"])
def test_merged_validation_equals_one_process(weights, ranks, mode):
    """Each rank validated its rows through the detection output (data
    parallel: one image a rank; spatial: two images a data coordinate,
    each image's rows over the two ``model`` ranks); the results merged
    over ``data`` in rank order give every rank the mAP of the
    one-process validation of the same trained weights."""
    got = [r[mode] for r in ranks.result()]
    model = SSDVgg(4, 300, device="cpu")
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in got[0]["state"].items()})
    model.eval()
    (want,) = validate(model, [_batch(2)], [pipe.SSDMeanAveragePrecision(
        n_classes=4, resolution=300)])
    for r in got:
        (score,) = [v for k, v in r["val"][-1].items() if k != "iteration"]
        np.testing.assert_allclose(score, want.result(), atol=1e-6)


@pytest.mark.parametrize("case", sorted(SPATIAL))
def test_spatial_forward_and_gradients_match_unsharded(weights, ranks,
                                                       case):
    """The rows over ``model`` = 2 and 4 (uneven and empty blocks, halos
    past a neighbour, ``-inf`` under the pools): every rank's whole
    ``(loc, conf)`` and, summed over ``model``, every gradient equal the
    unsharded port's on the same weights."""
    dtype, shape = SPATIAL[case]
    _, w = weights
    x, cot = _spatial_inputs(dtype, shape)
    model = SSDVgg(4, 300, device="cpu").to(torch.from_numpy(x).dtype)
    model.load_state_dict({k: torch.from_numpy(v.astype(dtype))
                           for k, v in w.items()})
    with torch.set_grad_enabled(dtype is np.float64):
        loc, conf = model(torch.from_numpy(x))
    if dtype is np.float64:
        ((loc * torch.from_numpy(cot[0])).sum()
         + (conf * torch.from_numpy(cot[1])).sum()).backward()
    tol = SPATIAL_TOL[dtype]
    got = [r[case] for r in ranks.result()]
    assert [r["rows"] for r in got] == [300 // shape[1]] * WORLD
    for rank, r in enumerate(got):
        rows = slice(rank // shape[1], rank // shape[1] + 1)
        for name, want in (("loc", loc), ("conf", conf)):
            want = want.detach().numpy()[rows]
            err = np.abs(r[name] - want).max() / np.abs(want).max()
            assert err <= tol, (name, err)
        if dtype is np.float32:
            continue
        for name, p in model.named_parameters():
            want = p.grad.numpy()
            err = (np.linalg.norm(r["grads"][name] - want)
                   / max(np.linalg.norm(want), 1e-300))
            assert err <= tol, (name, err)
