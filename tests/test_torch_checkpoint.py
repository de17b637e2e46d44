"""The port's checkpoint lifecycle (``parallel/checkpoint.py``) against the
JAX package's, on the CPU.

Every scenario of ``tests/test_checkpoint.py`` runs on both packages (the
port's payload is a ``torch.save`` of CPU tensors, the reference's an
orbax tree): the atomic publish and its manifest, a crash at
``pre_publish``, recovery from the trash slot, ``keep_last``, the
corrupt-newest fallback, a missing file, a checksum mismatch, all
snapshots corrupt, an explicit step pin, the ordering of candidates, the
``lkg`` and ``serve-lkg`` tiers, ``promote_tier`` and the
``CheckpointWatcher``.  Each returns what is comparable (which snapshot
was chosen, by its value; the manifest's meta keys; the exception
class's name), and the two records are EQUAL.  The reference's bare
orbax directory has no counterpart: every port snapshot has a manifest,
and a directory without one is refused.  Then a port-only round trip of
fp32, bf16, int64 and 0-d tensors, bit for bit, onto the requested
device.
"""

import os
import types

import numpy as np
import pytest
import torch

from analytics_zoo_tpu.parallel import checkpoint as jckpt
from analytics_zoo_tpu.resilience import errors as jerrors
from analytics_zoo_tpu_torch.parallel import checkpoint as tckpt
from analytics_zoo_tpu_torch.resilience import errors as terrors


def _jtree(v: float):
    return {"w": np.full((4, 3), v, np.float32),
            "step": np.asarray(7, np.int32)}


def _ttree(v: float):
    return {"w": torch.full((4, 3), v, dtype=torch.float32),
            "step": torch.tensor(7, dtype=torch.int32)}


PKGS = {
    "reference": types.SimpleNamespace(ckpt=jckpt, errors=jerrors,
                                       tree=_jtree, load_kw={}),
    "port": types.SimpleNamespace(ckpt=tckpt, errors=terrors, tree=_ttree,
                                  load_kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _clear_fault_hooks():
    yield
    jckpt.set_fault_hook(None)
    tckpt.set_fault_hook(None)


def _load(P, path, **kw):
    return P.ckpt.load(path, **{**P.load_kw, **kw})


def _w(out) -> float:
    return float(np.asarray(out["w"])[0, 0])


def _largest(man):
    return max(man["files"], key=lambda r: man["files"][r]["size"])


def _raises(P, exc_cls, fn, match=None):
    with pytest.raises(exc_cls, match=match) as e:
        fn()
    return type(e.value).__name__


# ---------------------------------------------------------------------------
# Scenarios: each returns its comparable record
# ---------------------------------------------------------------------------


def publish_layout_and_manifest(P, base):
    target = P.ckpt.save(base, P.tree(1.0), step=3,
                         meta={"epoch": 2, "iteration": 3})
    assert os.path.basename(target) == "step_3"
    man = P.ckpt.verify_snapshot(target)
    assert man["meta"]["epoch"] == 2
    assert man["meta"]["state_step"] == 7
    assert man["files"]
    assert not [d for d in os.listdir(base) if d.startswith(".tmp")]
    return {"name": os.path.basename(target), "meta": man["meta"],
            "format": man["format"]}


def mid_save_crash_keeps_previous(P, base):
    P.ckpt.save(base, P.tree(1.0))

    def bomb(phase, path):
        if phase == "pre_publish":
            raise P.errors.InjectedFault("crash mid-save")

    P.ckpt.set_fault_hook(bomb)
    err = _raises(P, P.errors.InjectedFault,
                  lambda: P.ckpt.save(base, P.tree(2.0)))
    P.ckpt.set_fault_hook(None)
    after_crash = _w(_load(P, base))
    P.ckpt.save(base, P.tree(3.0))
    return {"error": err, "after_crash": after_crash,
            "after_next_save": _w(_load(P, base))}


def crash_between_renames_recovers_from_trash(P, base):
    P.ckpt.save(base, P.tree(1.0))
    os.rename(os.path.join(base, "latest"),
              os.path.join(base, ".trash_latest"))
    has = P.ckpt.has_checkpoint(base)
    from_trash = _w(_load(P, base))
    P.ckpt.save(base, P.tree(2.0))
    return {"has": has, "from_trash": from_trash,
            "after_save": _w(_load(P, base)),
            "trash_left": os.path.isdir(os.path.join(base, ".trash_latest"))}


def keep_last_gc(P, base):
    for s in range(5):
        P.ckpt.save(base, P.tree(float(s)), step=s, keep_last=2)
    kept = sorted(d for d in os.listdir(base) if d.startswith("step_"))
    assert kept == ["step_3", "step_4"]
    return {"kept": kept, "loaded": _w(_load(P, base))}


def corrupt_latest_falls_back(P, base):
    P.ckpt.save(base, P.tree(1.0), step=1)
    t2 = P.ckpt.save(base, P.tree(2.0), step=2)
    man = P.ckpt.verify_snapshot(t2)
    with open(os.path.join(t2, _largest(man)), "r+b") as f:
        f.truncate(3)
    return {"loaded": _w(_load(P, base)),
            "newest_intact": os.path.basename(P.ckpt.newest_intact(base)[0])}


def missing_file_detected(P, base):
    t = P.ckpt.save(base, P.tree(1.0), step=1)
    man = P.ckpt.verify_snapshot(t)
    os.remove(os.path.join(t, next(iter(man["files"]))))
    return {"error": _raises(P, P.errors.CheckpointCorrupt,
                             lambda: P.ckpt.verify_snapshot(t),
                             match="missing file")}


def checksum_mismatch_detected(P, base):
    t = P.ckpt.save(base, P.tree(1.0), step=1)
    man = P.ckpt.verify_snapshot(t)
    full = os.path.join(t, _largest(man))
    data = bytearray(open(full, "rb").read())
    data[-1] ^= 0xFF
    open(full, "wb").write(bytes(data))
    return {"error": _raises(P, P.errors.CheckpointCorrupt,
                             lambda: P.ckpt.verify_snapshot(t),
                             match="checksum")}


def all_corrupt_raises(P, base):
    for s in (1, 2):
        t = P.ckpt.save(base, P.tree(float(s)), step=s)
        man = P.ckpt.verify_snapshot(t)
        with open(os.path.join(t, _largest(man)), "r+b") as f:
            f.truncate(1)
    return {"error": _raises(P, P.errors.CheckpointCorrupt,
                             lambda: _load(P, base),
                             match="no intact snapshot"),
            "newest_intact": P.ckpt.newest_intact(base)}


def explicit_step_pin_does_not_fall_back(P, base):
    P.ckpt.save(base, P.tree(1.0), step=1)
    t2 = P.ckpt.save(base, P.tree(2.0), step=2)
    man = P.ckpt.verify_snapshot(t2)
    with open(os.path.join(t2, next(iter(man["files"]))), "r+b") as f:
        f.truncate(1)
    return {"error": _raises(P, P.errors.CheckpointCorrupt,
                             lambda: _load(P, base, step=2)),
            "pinned_1": _w(_load(P, base, step=1))}


def latest_step_skips_manifestless_dirs(P, base):
    P.ckpt.save(base, P.tree(1.0), step=1)
    os.makedirs(os.path.join(base, "step_9"))
    return {"latest": P.ckpt.latest_step(base),
            "latest_any": P.ckpt.latest_step(base, require_manifest=False),
            "loaded": _w(_load(P, base))}


def stale_latest_does_not_outrank_newer_steps(P, base):
    P.ckpt.save(base, P.tree(1.0), meta={"iteration": 100})
    P.ckpt.save(base, P.tree(2.0), step=200, meta={"iteration": 200})
    d, _man = P.ckpt.newest_intact(base)
    first = (os.path.basename(d), _w(_load(P, base)))
    P.ckpt.save(base, P.tree(3.0), meta={"iteration": 300})
    return {"first": first, "fresher_latest": _w(_load(P, base))}


def newest_intact_ordering(P, base):
    P.ckpt.save(base, P.tree(1.0), step=1)
    P.ckpt.save(base, P.tree(2.0), step=2)
    d, man = P.ckpt.newest_intact(base)
    return {"dir": os.path.basename(d), "step": man["meta"]["step"]}


def direct_snapshot_dir_load(P, base):
    t = P.ckpt.save(base, P.tree(4.0), step=4)
    return {"loaded": _w(_load(P, t))}


def has_checkpoint(P, base):
    before = P.ckpt.has_checkpoint(base)
    P.ckpt.save(base, P.tree(1.0))
    return {"before": before, "after": P.ckpt.has_checkpoint(base)}


def save_and_verify_lkg(P, base):
    t = P.ckpt.save(base, P.tree(1.5), tier="lkg",
                    meta={"iteration": 9, "health_word": 0})
    snap, man = P.ckpt.lkg_snapshot(base)
    assert snap == t
    return {"name": os.path.basename(t), "meta": man["meta"],
            "loaded": _w(_load(P, snap))}


def lkg_overwrites_atomically(P, base):
    P.ckpt.save(base, P.tree(1.0), tier="lkg")
    P.ckpt.save(base, P.tree(2.0), tier="lkg")
    snap, _ = P.ckpt.lkg_snapshot(base)
    return {"loaded": _w(_load(P, snap))}


def lkg_is_not_a_resume_candidate(P, base):
    P.ckpt.save(base, P.tree(1.0), tier="lkg")
    P.ckpt.save(base, P.tree(9.0), step=3)
    d, _ = P.ckpt.newest_intact(base)
    base2 = base + "_only_lkg"
    P.ckpt.save(base2, P.tree(1.0), tier="lkg")
    return {"loaded": _w(_load(P, base)), "newest": os.path.basename(d),
            "only_lkg_has": P.ckpt.has_checkpoint(base2),
            "only_lkg_slot": P.ckpt.lkg_snapshot(base2) is not None}


def corrupt_lkg_returns_none(P, base):
    t = P.ckpt.save(base, P.tree(1.0), tier="lkg")
    man = P.ckpt.read_manifest(t)
    full = os.path.join(t, _largest(man))
    with open(full, "r+b") as f:
        f.truncate(os.path.getsize(full) // 2)
    return {"lkg": P.ckpt.lkg_snapshot(base)}


def unknown_tier_rejected(P, base):
    return {"error": _raises(P, ValueError,
                             lambda: P.ckpt.save(base, P.tree(1.0),
                                                 tier="bogus"),
                             match="unknown checkpoint tier")}


def promote_copies_exact_bytes(P, base):
    snap = P.ckpt.save(base, P.tree(4.0), step=7, meta={"iteration": 70})
    target = P.ckpt.promote_tier(base, snap, "serve-lkg")
    tier_dir, man = P.ckpt.tier_snapshot(base, "serve-lkg")
    assert tier_dir == target
    src = P.ckpt.read_manifest(snap)
    assert {r: f["sha256"] for r, f in man["files"].items()} == {
        r: f["sha256"] for r, f in src["files"].items()}
    np.testing.assert_array_equal(
        np.asarray(_load(P, tier_dir, verify=True)["w"]),
        np.asarray(P.tree(4.0)["w"]))
    return {"name": os.path.basename(target), "meta": man["meta"],
            "source_after": _w(_load(P, snap))}


def promote_refuses_corrupt_source(P, base):
    snap = P.ckpt.save(base, P.tree(1.0), step=1)
    man = P.ckpt.verify_snapshot(snap)
    full = os.path.join(snap, _largest(man))
    data = bytearray(open(full, "rb").read())
    data[-1] ^= 0xFF
    open(full, "wb").write(bytes(data))
    err = _raises(P, P.errors.CheckpointCorrupt,
                  lambda: P.ckpt.promote_tier(base, snap, "serve-lkg"))
    return {"error": err,
            "slot": P.ckpt.tier_snapshot(base, "serve-lkg")}


def promote_overwrites_previous_slot(P, base):
    s1 = P.ckpt.save(base, P.tree(1.0), step=1)
    s2 = P.ckpt.save(base, P.tree(2.0), step=2)
    P.ckpt.promote_tier(base, s1, "serve-lkg")
    P.ckpt.promote_tier(base, s2, "serve-lkg")
    tier_dir, man = P.ckpt.tier_snapshot(base, "serve-lkg")
    return {"from": man["meta"]["promoted_from"],
            "loaded": _w(_load(P, tier_dir))}


def promote_unknown_tier_rejected(P, base):
    snap = P.ckpt.save(base, P.tree(1.0), step=1)
    return {"error": _raises(P, ValueError,
                             lambda: P.ckpt.promote_tier(base, snap,
                                                         "bogus"),
                             match="unknown checkpoint tier")}


def watcher_reports_each_publish_once(P, base):
    P.ckpt.save(base, P.tree(1.0), step=1)
    w = P.ckpt.CheckpointWatcher(base)
    polls = [w.poll()]
    t2 = P.ckpt.save(base, P.tree(2.0), step=2)
    found = w.poll()
    assert found[0] == t2
    polls += [os.path.basename(found[0]), w.poll()]
    t3 = P.ckpt.save(base, P.tree(3.0), step=3)
    polls.append(os.path.basename(w.poll()[0]))
    assert polls[-1] == os.path.basename(t3)
    return {"polls": polls}


def watcher_ignores_tier_promotions(P, base):
    snap = P.ckpt.save(base, P.tree(1.0), step=1)
    w = P.ckpt.CheckpointWatcher(base)
    P.ckpt.promote_tier(base, snap, "serve-lkg")
    P.ckpt.save(base, P.tree(0.5), tier="lkg")
    return {"poll": w.poll()}


def watcher_skips_corrupt_publish(P, base):
    P.ckpt.save(base, P.tree(1.0), step=1)
    w = P.ckpt.CheckpointWatcher(base)
    t2 = P.ckpt.save(base, P.tree(2.0), step=2)
    man = P.ckpt.read_manifest(t2)
    full = os.path.join(t2, _largest(man))
    with open(full, "r+b") as f:
        f.truncate(os.path.getsize(full) // 2)
    first = w.poll()
    P.ckpt.save(base, P.tree(3.0), step=3)
    return {"first": first, "next": os.path.basename(w.poll()[0])}


SCENARIOS = {f.__name__: f for f in (
    publish_layout_and_manifest, mid_save_crash_keeps_previous,
    crash_between_renames_recovers_from_trash, keep_last_gc,
    corrupt_latest_falls_back, missing_file_detected,
    checksum_mismatch_detected, all_corrupt_raises,
    explicit_step_pin_does_not_fall_back,
    latest_step_skips_manifestless_dirs,
    stale_latest_does_not_outrank_newer_steps, newest_intact_ordering,
    direct_snapshot_dir_load, has_checkpoint, save_and_verify_lkg,
    lkg_overwrites_atomically, lkg_is_not_a_resume_candidate,
    corrupt_lkg_returns_none, unknown_tier_rejected,
    promote_copies_exact_bytes, promote_refuses_corrupt_source,
    promote_overwrites_previous_slot, promote_unknown_tier_rejected,
    watcher_reports_each_publish_once, watcher_ignores_tier_promotions,
    watcher_skips_corrupt_publish)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_checkpoint_scenario_equal_to_reference(name, tmp_path):
    ref = SCENARIOS[name](PKGS["reference"], str(tmp_path / "reference"))
    got = SCENARIOS[name](PKGS["port"], str(tmp_path / "port"))
    assert got == ref


# ---------------------------------------------------------------------------
# Port only
# ---------------------------------------------------------------------------


def test_manifestless_dir_is_refused(tmp_path):
    """No bare layout: every port snapshot has a manifest, and a
    directory without one is a partial write, never loaded."""
    d = tmp_path / "bare" / "latest"
    d.mkdir(parents=True)
    torch.save({"w": torch.ones(2)}, d / "state.pt")
    with pytest.raises(terrors.CheckpointCorrupt, match="manifest"):
        tckpt.load(str(tmp_path / "bare"), device="cpu")


def test_round_trip_dtypes_bit_equal_onto_requested_device(tmp_path):
    """fp32, bf16, int64 and 0-d tensors, nested containers and Python
    scalars come back bit for bit, onto ``device`` or each ``target``
    leaf's device; a view saves only its own bytes."""
    g = torch.Generator().manual_seed(0)
    big = torch.randn(64, 64, generator=g)
    state = {"fp32": torch.randn(3, 5, generator=g),
             "bf16": torch.randn(7, generator=g).to(torch.bfloat16),
             "int64": torch.randint(-2**40, 2**40, (4,), generator=g),
             "scalar": torch.tensor(3.25),
             "count": torch.tensor(11, dtype=torch.int32),
             "view": big[:2, :3],
             "nested": {"list": [torch.arange(3), 2.5], "tuple": (1, "a")},
             "step": 42}
    snap = tckpt.save(str(tmp_path / "c"), state, step=5)
    man = tckpt.verify_snapshot(snap)
    assert man["meta"]["state_step"] == 42
    assert man["files"]["data/state.pt"]["size"] < big.numel() * 4
    for out in (tckpt.load(str(tmp_path / "c"), device="cpu"),
                tckpt.load(str(tmp_path / "c"), target=state)):
        for k in ("fp32", "bf16", "int64", "scalar", "count", "view"):
            assert out[k].dtype == state[k].dtype, k
            assert out[k].shape == state[k].shape, k
            assert out[k].device.type == "cpu"
            assert torch.equal(out[k], state[k]), k
        assert torch.equal(out["nested"]["list"][0], torch.arange(3))
        assert out["nested"]["list"][1] == 2.5
        assert tuple(out["nested"]["tuple"]) == (1, "a")
        assert out["step"] == 42


def test_load_needs_a_device_or_a_target(tmp_path):
    """The state lands on the GPU unless the caller says otherwise: with
    no card, a load that names neither a device nor a target raises."""
    snap = tckpt.save(str(tmp_path / "c"), {"w": torch.ones(2)}, step=1)
    if torch.cuda.is_available():
        assert tckpt.load(snap)["w"].device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tckpt._restore(snap, None, True, None)
    with pytest.raises(terrors.CheckpointCorrupt):
        # a target of another structure is not this snapshot's state
        tckpt.load(str(tmp_path / "c"), target={"v": torch.ones(2)})


def test_save_timing_and_restore_elastic_refused(tmp_path):
    """``restore_elastic`` is served now (``tests/test_torch_elastic_mesh.
    py``): the snapshot comes back under a one-rank declaration."""
    import torch_dist_scenarios as sc
    from analytics_zoo_tpu_torch.parallel.specs import pipeline_specs

    tckpt.save(str(tmp_path / "c"), {"w": torch.ones(8)}, step=1)
    assert set(tckpt.last_save_s) == {"device_to_host", "serialize",
                                      "sha256", "publish"}
    got = tckpt.restore_elastic(
        str(tmp_path / "c"), {"w": torch.zeros(8)},
        pipeline_specs("fraud", mesh=sc.StubMesh({"data": 1})))
    assert torch.equal(got["w"], torch.ones(8))
