"""The port's program-audit suite: what ``az_analyze --program`` records
(counterpart of ``analysis/targets.py``).

Coverage: every registered pipeline's train and eval programs, the
Wide&Deep and persistent-RNN train programs, and every serving tier the
tier factories hand the runtime, with the reference's target names and
sizes (DS2 hidden 16 and T 32; SSD 300² with 4 classes; Faster-RCNN 128²
with 64 → 16 proposals; the batch the data axis's width).

Parameters are real tensors drawn from seeded generators at these sizes
and each program runs once (``analysis/program.py``), so the audit's
cost is its FLOPs at tiny sizes.  The serving-tier programs are not
rebuilt here: the factories attach a ``device_program`` thunk to each
:class:`~analytics_zoo_tpu_torch.serving.ladder.ServingTier`, and this
module audits exactly those.

Two choices differ from the reference's suite, for the card: the
``ssd/serve:*`` rungs take ``DetectionOutputParam(backend="pallas")``,
the unfused DetectionOutput whose suppression is K1 (the reference's
audit traced its unfused path on the CPU, where its ``"auto"`` is XLA;
on the card ``"auto"`` picks K2), and ``ssd-fused/serve:*`` takes
``backend="fused"`` (K2).  The DS2 serving rungs run with
``rnn_engine="pallas"`` (K3), the engine the card serves with.  The
``fraud-slice-w2`` rungs need two ranks and are audited by the spawned
scenarios (``tests/torch_dist_scenarios.py``), not by this suite.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from analytics_zoo_tpu_torch.analysis.program import (AuditProgram,
                                                      BuiltProgram,
                                                      ProgramWaiver)

#: the kernel ops each kernel-bearing target must record
KERNEL_TARGETS = {
    "ssd/serve:": ("K1",),
    "ssd-fused/serve:": ("K2",),
    "ds2/serve:": ("K3",),
    "ds2-pallas/train": ("K3", "K4"),
}


#: the programs the card's sync gate holds at zero debug-mode syncs: those
#: where the sync debug mode found host syncs the reference's programs do
#: not have (ROADMAP Queue 3, F6), with ``ssd/validate``, the validation
#: metric's detection over the eval step's logits (K2 on the card)
SYNC_TARGETS = ("ssd/train", "ssd/eval", "ssd/validate", "rec/train",
                "rec-wd/train", "sentiment/train", "frcnn/train",
                "frcnn/serve:int8")


def expected_kernels(name: str) -> Sequence[str]:
    """The kernel ops target ``name`` must record (none for most)."""
    for prefix, kernels in KERNEL_TARGETS.items():
        if name == prefix or (prefix.endswith(":")
                              and name.startswith(prefix)):
            return kernels
    return ()


def _gen(seed: int = 0) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def _uniform(shape, dev, seed: int, lo: float = 0.0, hi: float = 1.0):
    x = torch.rand(shape, generator=_gen(seed)) * (hi - lo) + lo
    return x.to(dev)


def _ints(shape, high: int, dev, seed: int) -> torch.Tensor:
    return torch.randint(0, high, shape, generator=_gen(seed),
                         dtype=torch.int32).to(dev)


def _train_state(module, state) -> Callable:
    """What a train step must update in place: the module's parameters
    and buffers and the optimizer's slots."""
    return lambda: {"params": list(module.parameters()),
                    "buffers": list(module.buffers()),
                    "opt_state": state.opt_state}


#: DS2's CTC loss reads its lengths on the host: torch's ``ctc_loss``
#: takes them as host integers and copies its offsets to the card, in the
#: forward and the backward (ROADMAP Known deviations)
_CTC_WHY = ("torch's ctc_loss takes its lengths on the host: CTCCriterion "
            "reads them, with the repeats that decide the infeasible rows, "
            "in one copy a step, and the CUDA loss and its backward copy "
            "their offsets to the card")
CTC_LENGTHS = tuple(
    ProgramWaiver("no-callbacks-in-hot-program", op, _CTC_WHY, device="cuda")
    for op in ("aten._to_copy", "aten._ctc_loss*"))


def _train(module, criterion, optim, batch, specs, waivers=(),
           **step_kw) -> BuiltProgram:
    from analytics_zoo_tpu_torch.parallel.train import (create_train_state,
                                                        make_train_step)

    if specs is not None:
        specs.place_state(module)
    state = create_train_state(module, optim)
    step = make_train_step(module, criterion, optim, specs=specs, **step_kw)
    return BuiltProgram(fn=step, args=(state, batch), specs=specs,
                        donate_state=_train_state(module, state),
                        waivers=tuple(waivers))


def _eval(module, inputs, specs) -> BuiltProgram:
    from analytics_zoo_tpu_torch.parallel.train import make_eval_step

    if specs is not None:
        specs.place_state(module)
    return BuiltProgram(fn=make_eval_step(module, specs=specs),
                        args=(inputs,), specs=specs)


# ---------------------------------------------------------------------------
# Per-pipeline target builders (lazy — nothing builds a model until the
# program engine runs)
# ---------------------------------------------------------------------------


def _fraud_model(dev):
    from analytics_zoo_tpu_torch.core.module import Model
    from analytics_zoo_tpu_torch.models import FraudMLP

    return Model(FraudMLP(in_features=29, hidden=10, n_classes=2),
                 device=dev).build(0, np.zeros((1, 29), np.float32))


def _fraud(mesh, dev) -> List[AuditProgram]:
    def build_train() -> BuiltProgram:
        from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
        from analytics_zoo_tpu_torch.parallel import Adam, pipeline_specs

        specs = pipeline_specs("fraud", mesh=mesh)
        B = specs.data_axis_size
        batch = {"input": _uniform((B, 29), dev, 1),
                 "target": _ints((B,), 2, dev, 2).long()}
        return _train(_fraud_model(dev).module,
                      ClassNLLCriterion(), Adam(1e-3), batch, specs)

    def build_eval() -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import pipeline_specs

        specs = pipeline_specs("fraud", mesh=mesh)
        return _eval(_fraud_model(dev).module,
                     _uniform((specs.data_axis_size, 29), dev, 3), specs)

    return [AuditProgram("fraud/train", build_train),
            AuditProgram("fraud/eval", build_eval)]


def _rec(mesh, dev) -> List[AuditProgram]:
    # the dedup'd-gather train and eval programs for both family
    # architectures: the sparse lookup and its backward are the hot path
    U, I, CLS = 64, 48, 5

    def pair(B, seed):
        return (_ints((B,), U, dev, seed).long(),
                _ints((B,), I, dev, seed + 1).long())

    def build(make, **kw) -> BuiltProgram:
        from analytics_zoo_tpu_torch.core.criterion import ClassNLLCriterion
        from analytics_zoo_tpu_torch.parallel import Adam, pipeline_specs

        specs = pipeline_specs("rec", mesh=mesh)
        B = specs.data_axis_size
        model = make(n_users=U, n_items=I, embedding_dim=8, hidden=(16, 8),
                     n_classes=CLS, device=dev, **kw)
        batch = {"input": pair(B, 4),
                 "target": _ints((B,), CLS, dev, 6).long()}
        return _train(model.module, ClassNLLCriterion(), Adam(1e-3),
                      batch, specs)

    def build_train() -> BuiltProgram:
        from analytics_zoo_tpu_torch.pipelines.recommendation import (
            make_ncf_model)
        return build(make_ncf_model, mf_embedding_dim=4)

    def build_wd_train() -> BuiltProgram:
        from analytics_zoo_tpu_torch.pipelines.recommendation import (
            make_wide_deep_model)
        return build(make_wide_deep_model, cross_buckets=32)

    def build_eval() -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import pipeline_specs
        from analytics_zoo_tpu_torch.pipelines.recommendation import (
            make_ncf_model)

        specs = pipeline_specs("rec", mesh=mesh)
        model = make_ncf_model(n_users=U, n_items=I, embedding_dim=8,
                               mf_embedding_dim=4, hidden=(16, 8),
                               n_classes=CLS, device=dev)
        return _eval(model.module, pair(specs.data_axis_size, 7), specs)

    return [AuditProgram("rec/train", build_train),
            AuditProgram("rec-wd/train", build_wd_train),
            AuditProgram("rec/eval", build_eval)]


def _sentiment_model(dev, T):
    from analytics_zoo_tpu_torch.pipelines.sentiment import (
        make_sentiment_model)

    return make_sentiment_model(vocab_size=256, embedding_dim=16, hidden=8,
                                head="gru", seq_len=T, device=dev)


def _sentiment(mesh, dev) -> List[AuditProgram]:
    T = 24

    def build_train() -> BuiltProgram:
        from analytics_zoo_tpu_torch.core.criterion import BCECriterion
        from analytics_zoo_tpu_torch.parallel import Adam, pipeline_specs

        specs = pipeline_specs("sentiment", mesh=mesh)
        B = specs.data_axis_size
        batch = {"input": _ints((B, T), 256, dev, 8).long(),
                 "target": _ints((B,), 2, dev, 9).float()}
        return _train(_sentiment_model(dev, T).module,
                      BCECriterion(), Adam(1e-3), batch, specs)

    def build_eval() -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import pipeline_specs

        specs = pipeline_specs("sentiment", mesh=mesh)
        return _eval(_sentiment_model(dev, T).module,
                     _ints((specs.data_axis_size, T), 256, dev, 10).long(),
                     specs)

    return [AuditProgram("sentiment/train", build_train),
            AuditProgram("sentiment/eval", build_eval)]


DS2_T, DS2_MELS, DS2_LAB = 32, 13, 4


def _ds2_model(dev, engine: Optional[str] = None, bidirectional=True):
    from analytics_zoo_tpu_torch.models import DeepSpeech2

    return DeepSpeech2(hidden=16, n_rnn_layers=1, n_mels=DS2_MELS,
                       bidirectional=bidirectional, rnn_engine=engine,
                       device=dev, seed=0)


def _ds2_batch(B, dev):
    # the bucketed-batch contract: input=(features, n_frames), n_frames
    # top-level for the CTC logit mask and the metric
    n = torch.full((B,), DS2_T, dtype=torch.int32, device=dev)
    return {"input": (_uniform((B, DS2_T, DS2_MELS), dev, 11, -1.0, 1.0), n),
            "n_frames": n,
            "labels": _ints((B, DS2_LAB), 28, dev, 12) + 1,
            "label_mask": torch.ones((B, DS2_LAB), device=dev)}


def _ds2(mesh, dev) -> List[AuditProgram]:
    def build(engine) -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import Adam, pipeline_specs
        from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
            ds2_ctc_criterion, ds2_padding_metric)

        specs = pipeline_specs("ds2", mesh=mesh)
        return _train(_ds2_model(dev, engine), ds2_ctc_criterion(),
                      Adam(1e-3), _ds2_batch(specs.data_axis_size, dev),
                      specs, waivers=CTC_LENGTHS,
                      metric_fn=ds2_padding_metric)

    def build_eval() -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import pipeline_specs

        specs = pipeline_specs("ds2", mesh=mesh)
        return _eval(_ds2_model(dev),
                     _uniform((specs.data_axis_size, DS2_T, DS2_MELS), dev,
                              13), specs)

    # the persistent-RNN engine's train program: K3 forward, K4 backward
    return [AuditProgram("ds2/train", lambda: build(None)),
            AuditProgram("ds2/eval", build_eval),
            AuditProgram("ds2-pallas/train", lambda: build("pallas"))]


SSD_RES, SSD_NCLS, SSD_G = 300, 4, 8


def _ssd_model(dev):
    from analytics_zoo_tpu_torch.models import SSDVgg

    return SSDVgg(num_classes=SSD_NCLS, resolution=SSD_RES, device=dev,
                  seed=0)


def _gt(B, G, dev, seed):
    lo = _uniform((B, G, 2), dev, seed, 0.0, 0.5)
    wh = _uniform((B, G, 2), dev, seed + 1, 0.1, 0.5)
    return torch.cat([lo, lo + wh], dim=-1)


def _ssd(mesh, dev) -> List[AuditProgram]:
    def build_train() -> BuiltProgram:
        from analytics_zoo_tpu_torch.models import build_priors, ssd300_config
        from analytics_zoo_tpu_torch.ops.multibox_loss import (
            MultiBoxLoss, MultiBoxLossParam)
        from analytics_zoo_tpu_torch.parallel import SGD, pipeline_specs

        specs = pipeline_specs("ssd", mesh=mesh)
        B = specs.data_axis_size
        priors, variances = build_priors(ssd300_config())
        crit = MultiBoxLoss(priors, variances,
                            MultiBoxLossParam(n_classes=SSD_NCLS))
        batch = {"input": _uniform((B, SSD_RES, SSD_RES, 3), dev, 14),
                 "target": {"bboxes": _gt(B, SSD_G, dev, 15),
                            "labels": (_ints((B, SSD_G), SSD_NCLS - 1, dev,
                                             16) + 1).float(),
                            "mask": torch.ones((B, SSD_G), device=dev)}}
        return _train(_ssd_model(dev), crit,
                      SGD(1e-3, momentum=0.9), batch, specs,
                      skip_loss_above=50.0)

    def build_eval() -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import pipeline_specs

        specs = pipeline_specs("ssd", mesh=mesh)
        return _eval(_ssd_model(dev),
                     _uniform((specs.data_axis_size, SSD_RES, SSD_RES, 3),
                              dev, 17), specs)

    return [AuditProgram("ssd/train", build_train),
            AuditProgram("ssd/eval", build_eval)]


def _ssd_validate(mesh, dev) -> AuditProgram:
    """The eval step and ``SSDMeanAveragePrecision.detect`` on its
    logits, as the ``Optimizer``'s validation runs them a batch (not in
    the reference's suite: its metric's priors are a program constant)."""
    def build() -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import pipeline_specs
        from analytics_zoo_tpu_torch.parallel.train import make_eval_step
        from analytics_zoo_tpu_torch.pipelines.ssd import (
            SSDMeanAveragePrecision)

        specs = pipeline_specs("ssd", mesh=mesh)
        module = _ssd_model(dev)
        specs.place_state(module)
        step = make_eval_step(module, specs=specs)
        metric = SSDMeanAveragePrecision(n_classes=SSD_NCLS,
                                         resolution=SSD_RES)
        x = _uniform((specs.data_axis_size, SSD_RES, SSD_RES, 3), dev, 17)
        return BuiltProgram(fn=lambda inputs: metric.detect(step(inputs)),
                            args=(x,), specs=specs)
    return AuditProgram("ssd/validate", build)


FRCNN_RES, FRCNN_NCLS, FRCNN_G = 128, 4, 8


def _frcnn_param():
    from analytics_zoo_tpu_torch.models import FrcnnParam
    from analytics_zoo_tpu_torch.ops.proposal import ProposalParam

    return FrcnnParam(num_classes=FRCNN_NCLS,
                      proposal=ProposalParam(pre_nms_topn=64,
                                             post_nms_topn=16))


def _frcnn_detector(dev, shared: dict):
    """One ``FasterRcnnDetector`` for every Faster-RCNN target of a
    suite; the train and eval targets run its ``FasterRcnnVgg``.  It is
    built on the meta device and given uniform weights of LeCun scale
    from a seeded generator: the audit reads what a program does, not its
    weights (the reference's suite filled 0.5), and the model's own
    truncated-normal draw of its 137M VGG16 parameters would be most of
    the suite's time on the CPU."""
    from analytics_zoo_tpu_torch.models import FasterRcnnDetector

    key = ("frcnn", str(dev))
    if key not in shared:
        with torch.device("meta"):
            det = FasterRcnnDetector(param=_frcnn_param(), device="meta")
        det.to_empty(device="cpu")
        gen = _gen(0)
        with torch.no_grad():
            for p in det.parameters():
                bound = p[0].numel() ** -0.5 if p.dim() > 1 else 0.0
                p.uniform_(-bound, bound, generator=gen)
        shared[key] = det.to(dev)
    return shared[key]


def _frcnn(mesh, dev, shared: dict) -> List[AuditProgram]:
    R = FRCNN_RES

    def build_train() -> BuiltProgram:
        from analytics_zoo_tpu_torch.ops.frcnn_train import (
            FrcnnLossParam, frcnn_training_loss)
        from analytics_zoo_tpu_torch.parallel import SGD, pipeline_specs
        from analytics_zoo_tpu_torch.pipelines.frcnn import frcnn_forward_fn

        specs = pipeline_specs("frcnn", mesh=mesh)
        B = specs.data_axis_size
        gt = _gt(B, FRCNN_G, dev, 18) * R
        mask = torch.ones((B, FRCNN_G), device=dev)
        info = torch.tensor([[R, R, 1.0]] * B, device=dev)
        batch = {"input": (_uniform((B, R, R, 3), dev, 19, -1.0, 1.0), info,
                           gt, mask),
                 "im_info": info,
                 "target": {"bboxes": gt,
                            "labels": _ints((B, FRCNN_G), FRCNN_NCLS - 1,
                                            dev, 20) + 1,
                            "mask": mask}}
        loss_param = FrcnnLossParam()
        return _train(
            _frcnn_detector(dev, shared).frcnn,
            lambda out, b: frcnn_training_loss(out, b, loss_param),
            SGD(1e-3, momentum=0.9), batch, specs,
            forward_fn=frcnn_forward_fn, grad_clip_norm=10.0)

    def build_eval() -> BuiltProgram:
        from analytics_zoo_tpu_torch.parallel import pipeline_specs

        specs = pipeline_specs("frcnn", mesh=mesh)
        B = specs.data_axis_size
        return _eval(_frcnn_detector(dev, shared).frcnn,
                     (_uniform((B, R, R, 3), dev, 21, -1.0, 1.0),
                      torch.tensor([[R, R, 1.0]] * B, device=dev)), specs)

    return [AuditProgram("frcnn/train", build_train),
            AuditProgram("frcnn/eval", build_eval)]


# ---------------------------------------------------------------------------
# Serving tiers
# ---------------------------------------------------------------------------


def _tier_targets(kind: str, tiers, specs,
                  waivers: Sequence[ProgramWaiver] = ()
                  ) -> List[AuditProgram]:
    """Wrap each ServingTier's attached ``device_program`` thunk as an
    audit target (a tier without one is itself a finding — the factory
    stopped exposing its program to the audit)."""
    out: List[AuditProgram] = []
    for tier in tiers:
        name = f"{kind}/serve:{tier.name}"
        if tier.device_program is None:
            def build_missing(tier_name=tier.name) -> BuiltProgram:
                raise RuntimeError(
                    f"serving tier {tier_name!r} carries no "
                    f"device_program thunk — the tier factory must "
                    f"expose its program for the audit")
            out.append(AuditProgram(name, build_missing))
            continue

        def build(thunk=tier.device_program, specs=specs) -> BuiltProgram:
            fn, args = thunk()
            return BuiltProgram(fn=fn, args=args, specs=specs,
                                waivers=tuple(waivers))
        out.append(AuditProgram(name, build))
    return out


def _ssd_serving(mesh, dev) -> List[AuditProgram]:
    from analytics_zoo_tpu_torch.ops import DetectionOutputParam
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.ssd import (PreProcessParam,
                                                       ssd_serving_tiers)

    model = _ssd_model(dev)
    specs = pipeline_specs("ssd", mesh=mesh)
    param = PreProcessParam(batch_size=specs.data_axis_size,
                            resolution=SSD_RES)
    unfused = ssd_serving_tiers(
        model, param, n_classes=SSD_NCLS, specs=specs, device=dev,
        post=DetectionOutputParam(n_classes=SSD_NCLS, backend="pallas"))
    fused = ssd_serving_tiers(
        model, param, n_classes=SSD_NCLS, specs=specs, device=dev,
        post=DetectionOutputParam(n_classes=SSD_NCLS, backend="fused"))
    return (_tier_targets("ssd", unfused, specs)
            + _tier_targets("ssd-fused", fused, specs))


def _ds2_serving(mesh, dev) -> List[AuditProgram]:
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        DS2Param, ds2_serving_tiers)

    specs = pipeline_specs("ds2", mesh=mesh)
    tiers = ds2_serving_tiers(_ds2_model(dev, "pallas"),
                              DS2Param(decoder="beam"), specs=specs,
                              device=dev)
    return _tier_targets("ds2", tiers, specs)


def _ds2_streaming_serving(mesh, dev) -> List[AuditProgram]:
    # the streaming session model: the steady block's carry-in/carry-out
    # program every chunk dispatches
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.deepspeech2 import (
        ds2_streaming_tiers)

    specs = pipeline_specs("ds2", mesh=mesh)
    tiers = ds2_streaming_tiers(_ds2_model(dev, bidirectional=False),
                                n_mels=DS2_MELS, chunk_frames=50, device=dev)
    return _tier_targets("ds2-stream", tiers, specs)


def _frcnn_serving(mesh, dev, shared: dict) -> List[AuditProgram]:
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.frcnn import frcnn_serving_tiers
    from analytics_zoo_tpu_torch.pipelines.ssd import PreProcessParam

    specs = pipeline_specs("frcnn", mesh=mesh)
    tiers = frcnn_serving_tiers(
        _frcnn_detector(dev, shared),
        param=PreProcessParam(batch_size=specs.data_axis_size,
                              resolution=FRCNN_RES),
        specs=specs, device=dev)
    return _tier_targets("frcnn", tiers, specs)


def _fraud_serving(mesh, dev) -> List[AuditProgram]:
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.fraud import fraud_serving_tiers

    specs = pipeline_specs("fraud", mesh=mesh)
    return _tier_targets("fraud", fraud_serving_tiers(
        _fraud_model(dev), specs=specs, device=dev), specs)


def _fraud_swapped_serving(mesh, dev) -> List[AuditProgram]:
    """``ServingRuntime.hot_swap`` rebuilds a family's tiers from a
    restored checkpoint (a ``state_dict`` of host arrays) loaded into the
    model: the programs a swapped-in replica dispatches stay under the
    audit like the boot-time ones."""
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.fraud import fraud_serving_tiers

    model = _fraud_model(dev)
    restored = {k: torch.from_numpy(v.detach().cpu().numpy().copy())
                for k, v in model.module.state_dict().items()}
    model.module.load_state_dict(restored)
    specs = pipeline_specs("fraud", mesh=mesh)
    return _tier_targets("fraud-swapped", fraud_serving_tiers(
        model, specs=specs, device=dev), specs)


def _fraud_slice_serving(mesh, dev) -> List[AuditProgram]:
    """The width-2 replica slice: the fraud tiers on this rank's slice of
    a ``SliceLayout`` of width 2 (a sub-mesh through
    ``SpecSet.replace_mesh`` where the world is wider), as the runtime
    builds a slice's programs.  Every rank calls it (the layout's groups
    are collective) and audits its own slice; the world needs an even
    number of ranks."""
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.fraud import fraud_serving_tiers
    from analytics_zoo_tpu_torch.serving.follower import SliceLayout

    specs = SliceLayout(pipeline_specs("fraud", mesh=mesh), width=2).specs
    return _tier_targets("fraud-slice-w2", fraud_serving_tiers(
        _fraud_model(dev), specs=specs, device=dev), specs)


def _rec_serving(mesh, dev) -> List[AuditProgram]:
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.recommendation import (
        make_ncf_model, rec_serving_tiers)

    model = make_ncf_model(n_users=64, n_items=48, embedding_dim=8,
                           mf_embedding_dim=4, hidden=(16, 8), device=dev)
    specs = pipeline_specs("rec", mesh=mesh)
    return _tier_targets("rec", rec_serving_tiers(model, specs=specs,
                                                  device=dev), specs)


def _sentiment_serving(mesh, dev) -> List[AuditProgram]:
    from analytics_zoo_tpu_torch.parallel import pipeline_specs
    from analytics_zoo_tpu_torch.pipelines.sentiment import (
        sentiment_serving_tiers)

    T = 24
    specs = pipeline_specs("sentiment", mesh=mesh)
    return _tier_targets("sentiment", sentiment_serving_tiers(
        _sentiment_model(dev, T), specs=specs, seq_len=T, device=dev), specs)


def _guarded_tiers(kind: str, builder, mesh, dev=None, **kw
                   ) -> List[AuditProgram]:
    """The serving-tier targets need the tier FACTORIES to run before
    the target names are even known (names come from the rungs).  A
    factory that explodes must surface as a finding on that family —
    not crash suite construction and take the healthy train/eval
    targets down with it."""
    try:
        return builder(mesh, dev, **kw)
    except Exception as e:
        msg = f"{type(e).__name__}: {e}"

        def build_fail() -> BuiltProgram:
            raise RuntimeError(
                f"serving-tier factory failed before any program could "
                f"run: {msg}")
        return [AuditProgram(f"{kind}/serve:<factory-failed>", build_fail)]


def repo_audit_suite(mesh=None, device=None) -> List[AuditProgram]:
    """Every program the audit covers, lazily built on ``mesh`` (default:
    a 1-D data mesh over every rank) and ``device`` (the GPU unless
    ``device="cpu"``)."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mesh = mesh or mesh_lib.create_mesh()
    targets: List[AuditProgram] = []
    targets += _ssd(mesh, dev)
    shared: dict = {}
    targets += _frcnn(mesh, dev, shared)
    targets += _ds2(mesh, dev)
    targets += _fraud(mesh, dev)
    targets += _rec(mesh, dev)
    targets += _sentiment(mesh, dev)
    targets += _guarded_tiers("ssd", _ssd_serving, mesh, dev)
    targets += _guarded_tiers("ds2", _ds2_serving, mesh, dev)
    targets += _guarded_tiers("ds2-stream", _ds2_streaming_serving, mesh,
                              dev)
    targets += _guarded_tiers("frcnn", _frcnn_serving, mesh, dev,
                              shared=shared)
    targets += _guarded_tiers("fraud", _fraud_serving, mesh, dev)
    targets += _guarded_tiers("fraud-swapped", _fraud_swapped_serving, mesh,
                              dev)
    targets += _guarded_tiers("rec", _rec_serving, mesh, dev)
    targets += _guarded_tiers("sentiment", _sentiment_serving, mesh, dev)
    return targets


def kernel_audit_suite(mesh=None, device=None) -> List[AuditProgram]:
    """The kernel-bearing targets alone (:data:`KERNEL_TARGETS`):
    ``ssd/serve:*`` (K1), ``ssd-fused/serve:*`` (K2), ``ds2/serve:*``
    (K3) and ``ds2-pallas/train`` (K3, K4), at the suite's sizes."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mesh = mesh or mesh_lib.create_mesh()
    return (_guarded_tiers("ssd", _ssd_serving, mesh, dev)
            + _guarded_tiers("ds2", _ds2_serving, mesh, dev)
            + [t for t in _ds2(mesh, dev) if expected_kernels(t.name)])


def sync_audit_suite(mesh=None, device=None,
                     names: Sequence[str] = SYNC_TARGETS
                     ) -> List[AuditProgram]:
    """The targets of :data:`SYNC_TARGETS` (those among ``names``), at
    the suite's sizes."""
    from analytics_zoo_tpu_torch.parallel import mesh as mesh_lib
    from analytics_zoo_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mesh = mesh or mesh_lib.create_mesh()
    shared: dict = {}
    targets = (_ssd(mesh, dev) + [_ssd_validate(mesh, dev)]
               + _rec(mesh, dev) + _sentiment(mesh, dev)
               + _frcnn(mesh, dev, shared))
    if any(n.startswith("frcnn/serve:") for n in names):
        targets += _guarded_tiers("frcnn", _frcnn_serving, mesh, dev,
                                  shared=shared)
    return [t for t in targets if t.name in names]
