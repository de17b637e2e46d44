"""Elastic re-placement of the port (``SpecSet.replace_mesh``,
``checkpoint.restore_elastic``) against the JAX package's
``tests/test_elastic_mesh.py`` training half.

``replace_mesh`` keeps the declaration and refuses to drop an axis the
declaration resolves; a batch-override axis the mesh lacks fails at the
substrate's boundary; a snapshot that does not match its target is named
as such.  The width-change matrix: for every registered pipeline, a
state placed, gathered and saved by 4 gloo ranks restores onto 2 and 1
ranks with the saved bytes, and one step from it equals, bit for bit,
the step from a never-resized placement at that width.  The serving
half's policy and pool scenarios are ``tests/test_torch_autoscale.py``'s.

The 4-rank group also runs the fleet's multi-rank cases: two
``slice_width=2`` replicas (slice 1 driven remotely from rank 0) serving
the fraud rungs equal to one process's, a third slice refused by the
device budget; and a tiny DS2 under the parity audit, un-armed every
audit ``ok``, then a ``bit_flip`` on rank 2 raising
``DeviceQuarantine(device=2)`` on every rank, rank 2 leaving, and the 3
survivors' step from the last-known-good tier bit-equal to a straight
width-3 run from the same snapshot.
"""

import jax
import numpy as np
import pytest
import torch

import torch_dist_scenarios as sc
from analytics_zoo_tpu.parallel import create_mesh as jax_mesh
from analytics_zoo_tpu.parallel import pipeline_specs as jax_specs
from analytics_zoo_tpu.resilience.errors import (
    ElasticPlacementError as JaxElasticPlacementError)
from analytics_zoo_tpu_torch.parallel import checkpoint as ckpt_lib
from analytics_zoo_tpu_torch.parallel.mesh import PartitionSpec as P
from analytics_zoo_tpu_torch.parallel.specs import (SpecSet, pipeline_specs,
                                                    registered_pipelines)
from analytics_zoo_tpu_torch.resilience.errors import ElasticPlacementError
from analytics_zoo_tpu_torch.utils import engine

SAVE_W, RESTORE_WS = 4, (2, 1)


def _stub(**shape):
    return sc.StubMesh(shape)


class TestReplaceMesh:
    def test_same_declaration_new_mesh(self):
        full, half = _stub(data=8), _stub(data=4)
        specs = pipeline_specs("fraud", mesh=full)
        resized = specs.replace_mesh(half)
        assert resized.mesh is half
        assert resized.data_axis_size == 4
        assert resized.rules == specs.rules
        assert resized.batch_overrides == specs.batch_overrides
        assert specs.data_axis_size == 8

    def test_dropping_an_active_axis_is_refused(self):
        """The megatron rules resolve on a data × model mesh: re-placing
        onto a pure data mesh would de-shard the weights silently; both
        packages refuse by name."""
        specs = pipeline_specs("ssd", mesh=_stub(data=2, model=4),
                               tp="megatron")
        with pytest.raises(ElasticPlacementError, match="model"):
            specs.replace_mesh(_stub(data=4))
        jspecs = jax_specs("ssd", mesh=jax_mesh(
            (2, 4), axis_names=("data", "model")), tp="megatron")
        with pytest.raises(JaxElasticPlacementError, match="model"):
            jspecs.replace_mesh(jax_mesh(devices=jax.devices()[:4]))

    def test_unresolved_declared_axis_moves_freely(self):
        specs = pipeline_specs("rec", mesh=_stub(data=8))
        assert "model" in specs.missing_axes()
        assert specs.declared_axes() == {"model"}
        resized = specs.replace_mesh(_stub(data=2))
        assert resized.data_axis_size == 2


class TestElasticPlacementBoundary:
    def test_override_axes_missing_from_mesh_named_error(self):
        specs = SpecSet(_stub(data=8),
                        batch_overrides={"input": P("data", "model")})
        with pytest.raises(ElasticPlacementError, match="model"):
            specs.place_state({"w": torch.zeros(4)})
        with pytest.raises(ElasticPlacementError, match="model"):
            specs.place_batch({"input": np.zeros((8, 4), np.float32)})

    def test_restore_elastic_structure_mismatch_named_error(self, tmp_path):
        base = str(tmp_path / "c")
        ckpt_lib.save(base, {"w": torch.ones(4)})
        specs = pipeline_specs("fraud", mesh=_stub(data=1))
        with pytest.raises(ElasticPlacementError, match="structure"):
            ckpt_lib.restore_elastic(
                base, target={"w": torch.ones(4), "extra": torch.ones(2)},
                specs=specs)
        # the same snapshot, the right target: the bytes come back
        got = ckpt_lib.restore_elastic(base, target={"w": torch.zeros(4)},
                                       specs=specs)
        assert torch.equal(got["w"], torch.ones(4))


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """Each registered pipeline's state saved by 4 ranks, then restored by
    2 and by 1."""
    base = tmp_path_factory.mktemp("elastic")
    names = sorted(registered_pipelines())

    def group(world, restore, extra=None):
        return engine.spawn(sc.TARGET, world, {"scenarios": {
            **{n: ("elastic_matrix", dict(name=n, base=str(base / n),
                                          restore=restore))
               for n in names}, **(extra or {})}},
            device="cpu", timeout=180)

    # the fleet's cases after the matrix: the eviction last (its evicted
    # rank leaves the run)
    four = group(SAVE_W, False, {
        "slices": ("serve_slices", {}),
        "sdc": ("sdc_eviction", dict(base=str(base / "sdc")))})
    return {SAVE_W: four, **{w: group(w, True) for w in RESTORE_WS}}


class TestWidthChangeMatrix:
    def test_registry_is_the_expected_zoo(self):
        assert set(registered_pipelines()) == {
            "ssd", "frcnn", "ds2", "fraud", "rec", "sentiment"}

    @pytest.mark.parametrize("name", sorted(registered_pipelines()))
    def test_save_at_4_restore_at_narrower_bitexact(self, matrix, name):
        for w in RESTORE_WS:
            for got in (r[name] for r in matrix[w]):
                assert got["equal"], (name, w)
                loss, state = got["elastic"]
                want_loss, want_state = got["control"]
                assert loss == want_loss, (name, w)
                for k, v in want_state.items():
                    assert np.array_equal(state[k], v), (name, w, k)


class TestFleetOnFourRanks:
    def test_two_slices_serve_equal_to_one_process(self, matrix):
        got = matrix[SAVE_W][0]["slices"]
        assert got["layout"] == [[0, 1], [2, 3]]
        assert got["max_diff"] <= 1e-6
        assert got["accounting"]["unaccounted"] == 0
        assert got["accounting"]["by_state"] == {"done": 24}
        assert all(n > 0 for n in got["dispatches"].values())
        assert got["grown"] == [] and got["clamped"][0]["width"] == 2
        assert got["slices"]["devices_used"] == 4
        assert got["slices"]["device_budget"] == 4
        for follower in matrix[SAVE_W][1:]:
            counts = follower["slices"]
            assert counts["run"] > 0 and counts["failed"] == 0

    def test_audit_quarantine_and_survivors(self, matrix):
        ranks = [r["sdc"] for r in matrix[SAVE_W]]
        for r in ranks:
            assert r["clean"]["audits"] == 3
            assert r["clean"]["audit_divergences"] == 0
            assert r["raised"] == ("DeviceQuarantine", 2)
            assert r["divergence"][0]["minority"] == [2]
            assert r["divergence"][0]["step"] == 5
        assert [r["evicted"] for r in ranks] == [False, False, True, False]
        for r in (ranks[0], ranks[1], ranks[3]):
            assert r["width"] == 3 and r["equal"]
            assert r["losses"][0] == r["losses"][1]
            assert r["stats"]["audit_divergences"] == 0
