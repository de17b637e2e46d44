"""The port's SSD backbone variants (``models/ssd_variants.py``) against
the JAX package, on the CPU: the configs and priors, the heads' shapes
against the priors, the raw ``(loc, conf)`` on weights bridged from
numpy-seeded flax params, and serving through ``SSDPredictor`` with the
variant's own priors.

Tolerance: ``(loc, conf)`` within ``OUT_TOL`` (relative to the output's
largest magnitude): the two convolution libraries sum in another order
(measured ~1e-6); priors are computed by the same float ops and held
equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from analytics_zoo_tpu.models import ssd as jax_ssd
from analytics_zoo_tpu.models import ssd_variants as jax_var
from analytics_zoo_tpu_torch.models import (SSDAlexNet, SSDMobileNet,
                                            alexnet_ssd_config, build_priors,
                                            mobilenet_ssd_config,
                                            num_priors_per_cell)
from analytics_zoo_tpu_torch.ops.detection_output import (
    DetectionOutputParam, detection_output)
from analytics_zoo_tpu_torch.pipelines import ssd as pipe
from analytics_zoo_tpu_torch.utils.convert import (
    ssd_alexnet_params_from_jax, ssd_mobilenet_params_from_jax)

torch.set_num_threads(2)
OUT_TOL = 1e-5


def _prior_total(cfg):
    return sum(k * f * f for k, f in zip(num_priors_per_cell(cfg),
                                         cfg.feature_shapes))


@pytest.mark.parametrize("name", ["alexnet", "mobilenet"])
def test_configs_and_priors_equal_reference(name):
    mine = {"alexnet": alexnet_ssd_config,
            "mobilenet": mobilenet_ssd_config}[name]()
    ref = {"alexnet": jax_var.alexnet_ssd_config,
           "mobilenet": jax_var.mobilenet_ssd_config}[name]()
    assert mine == type(mine)(**{f: getattr(ref, f) for f in (
        "resolution", "feature_shapes", "min_sizes", "max_sizes",
        "aspect_ratios", "steps")})
    got, want = build_priors(mine), jax_ssd.build_priors(ref)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    assert got[0].shape == (_prior_total(mine), 4)


def _seeded(module, x, seed=0):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), x)
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        if path[-1].key == "kernel":
            v = rng.randn(*leaf.shape) / np.sqrt(np.prod(leaf.shape[:-1]))
        else:
            v = rng.randn(*leaf.shape) * 0.01
        return v.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes["params"])


CASES = {
    "alexnet": (lambda: jax_var.SSDAlexNet(num_classes=21),
                lambda: SSDAlexNet(21, device="cpu", seed=1),
                ssd_alexnet_params_from_jax),
    "mobilenet": (lambda: jax_var.SSDMobileNet(num_classes=21,
                                               width_mult=0.25),
                  lambda: SSDMobileNet(21, width_mult=0.25, device="cpu",
                                       seed=1),
                  ssd_mobilenet_params_from_jax),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    jmake, tmake, bridge = CASES[request.param]
    jmodel, tmodel = jmake(), tmake()
    x = (np.random.RandomState(2).rand(2, 300, 300, 3) * 255 - 120).astype(
        np.float32)
    params = _seeded(jmodel, jnp.zeros((1, 300, 300, 3)))
    tmodel.load_state_dict(bridge(params, tmodel))
    return request.param, jmodel, params, tmodel, x


def test_head_shapes_match_priors(pair):
    _, _, _, tmodel, x = pair
    P = _prior_total(tmodel.config)
    with torch.no_grad():
        loc, conf = tmodel(torch.from_numpy(x[:1]))
    assert loc.shape == (1, P, 4) and conf.shape == (1, P, 21)
    assert build_priors(tmodel.config)[0].shape == (P, 4)


def test_outputs_match_reference(pair):
    name, jmodel, params, tmodel, x = pair
    want = jmodel.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x))
    for g, w in zip(got, want):
        w = np.asarray(w)
        err = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert err <= OUT_TOL, (name, err)


def test_predictor_serves_with_the_variants_priors(pair):
    """``SSDPredictor`` takes the variant's priors; its detections are
    the plain DetectionOutput over the model's softmaxed outputs and
    those priors."""
    _, _, _, tmodel, x = pair
    pred = pipe.SSDPredictor(tmodel, pipe.PreProcessParam(batch_size=2),
                             device="cpu")
    priors, variances = build_priors(tmodel.config)
    np.testing.assert_array_equal(pred._priors.numpy(), priors)
    inputs = torch.from_numpy(x)
    got = pred.detect_normalized(inputs)
    with torch.no_grad():
        loc, conf = tmodel(inputs)
    want = detection_output(loc, torch.softmax(conf, -1),
                            torch.from_numpy(priors),
                            torch.from_numpy(variances),
                            DetectionOutputParam(n_classes=21))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert got.shape == (2, 200, 6) and (got[..., 0] >= 0).any()
