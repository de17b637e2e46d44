"""Criterions of the port (counterpart of ``core/criterion.py``): a
criterion is a callable ``loss = crit(input, target)`` returning a
scalar, with an optional ``mask`` (1.0 = a valid element) for padded
batches: ``ClassNLLCriterion``, ``CrossEntropyCriterion``,
``BCECriterion``, ``SmoothL1Criterion``, ``MSECriterion``,
``ParallelCriterion`` and ``CTCCriterion``.  The SSD ``MultiBoxLoss``
lives in ``ops/multibox_loss.py`` with the rest of the detection math.

``CTCCriterion`` is the reference's ``optax.ctc_loss`` per sequence,
averaged over the batch.  A feasible row goes through ``F.ctc_loss``
(``reduction="none"``: ``"mean"`` would also divide by the target
length) on the ``log_softmax`` of the input, as optax normalizes its
input (the identity on DS2's log-probs).  A row with no alignment (fewer
valid frames than labels plus repeats) has an infinite loss under
``F.ctc_loss``; optax gives a large finite one, because it stands
``log_epsilon = -1e5`` in for log 0, so such rows run
:func:`ctc_loss_plain`, optax's recursion written out, and get its value
and gradient.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from analytics_zoo_tpu_torch.utils.spmd import global_count, global_width


class Criterion:
    """Base class; subclasses implement ``__call__(input, target) ->
    scalar``."""

    def __call__(self, inputs, target):  # pragma: no cover - interface
        raise NotImplementedError


def _reduce(x: torch.Tensor, mask=None, size_average: bool = True):
    """Sum of ``x`` (times ``mask``), divided by the count of valid
    elements (at least 1) or by ``x``'s size under ``size_average``."""
    if mask is not None:
        mask = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
        x = x * mask
        # over a data axis the count is the global batch's, and a rank's
        # share of the mean is scaled so that the ranks' average is it
        denom = torch.clamp(global_count(mask.sum()), min=1.0) \
            / global_width()
    else:
        denom = x.numel()
    total = x.sum()
    return total / denom if size_average else total


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities (pairs with a
    ``LogSoftMax`` output layer); targets are 0-based ints."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def __call__(self, log_probs, target, mask=None):
        target = torch.as_tensor(target, device=log_probs.device).long()
        nll = -torch.take_along_dim(log_probs, target[..., None], -1)[..., 0]
        return _reduce(nll, mask, self.size_average)


class CrossEntropyCriterion(Criterion):
    """Softmax cross-entropy over raw logits (``LogSoftMax`` and
    ``ClassNLL`` in one): ``logsumexp(logits) - logits[target]``."""

    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def __call__(self, logits, target, mask=None):
        target = torch.as_tensor(target, device=logits.device).long()
        nll = (torch.logsumexp(logits, -1)
               - torch.take_along_dim(logits, target[..., None], -1)[..., 0])
        return _reduce(nll, mask, self.size_average)


class BCECriterion(Criterion):
    """Binary cross-entropy on probabilities, clipped to [eps, 1 - eps]."""

    def __init__(self, size_average: bool = True, eps: float = 1e-7):
        self.size_average = size_average
        self.eps = eps

    def __call__(self, probs, target, mask=None):
        p = torch.clamp(probs, self.eps, 1.0 - self.eps)
        target = torch.as_tensor(target, dtype=p.dtype, device=p.device)
        bce = -(target * torch.log(p) + (1.0 - target) * torch.log(1.0 - p))
        return _reduce(bce, mask, self.size_average)


def smooth_l1(diff: torch.Tensor, sigma: float = 1.0) -> torch.Tensor:
    """Elementwise smooth-L1 (Huber) in Caffe's sigma form: 0.5·(σd)² for
    |d| < 1/σ², else |d| − 0.5/σ²."""
    s2 = sigma * sigma
    ad = torch.abs(diff)
    return torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)


class SmoothL1Criterion(Criterion):
    def __init__(self, size_average: bool = True, sigma: float = 1.0):
        self.size_average = size_average
        self.sigma = sigma

    def __call__(self, inputs, target, mask=None):
        return _reduce(smooth_l1(inputs - target, self.sigma), mask,
                       self.size_average)


class MSECriterion(Criterion):
    def __init__(self, size_average: bool = True):
        self.size_average = size_average

    def __call__(self, inputs, target, mask=None):
        return _reduce((inputs - target) ** 2, mask, self.size_average)


class ParallelCriterion(Criterion):
    """Weighted sum of sub-criterions over paired (input, target)
    sequences."""

    def __init__(self, criterions: Sequence[Tuple[Criterion, float]] = ()):
        self.criterions = list(criterions)

    def add(self, criterion: Criterion,
            weight: float = 1.0) -> "ParallelCriterion":
        self.criterions.append((criterion, weight))
        return self

    def __call__(self, inputs, targets):
        if (len(inputs) != len(self.criterions)
                or len(targets) != len(self.criterions)):
            raise ValueError(
                f"ParallelCriterion has {len(self.criterions)} "
                f"sub-criterions but got {len(inputs)} inputs / "
                f"{len(targets)} targets")
        total = 0.0
        for (crit, w), inp, tgt in zip(self.criterions, inputs, targets):
            total = total + w * crit(inp, tgt)
        return total


def ctc_loss_plain(logits: torch.Tensor, logit_paddings: torch.Tensor,
                   labels: torch.Tensor, label_paddings: torch.Tensor,
                   blank_id: int = 0,
                   log_epsilon: float = -1e5) -> torch.Tensor:
    """optax's ``ctc_loss`` in PyTorch, step for step: ``(B, T, K)``
    logits, ``(B, T)`` and ``(B, N)`` padding indicators (1.0 = padded),
    ``(B, N)`` labels, right-padded → the ``(B,)`` per-sequence loss.
    Differentiable by autograd; a loop over T."""
    B, _, K = logits.shape
    N = labels.shape[1]
    logprobs = torch.log_softmax(logits.float(), -1)
    labellens = N - label_paddings.sum(1).long()
    repeat = F.pad((labels[:, :-1] == labels[:, 1:]).float(), (0, 1))
    logprobs_phi = logprobs[:, :, blank_id:blank_id + 1].transpose(0, 1)
    one_hot = F.one_hot(labels.long(), K).float()
    logprobs_emit = torch.einsum("btk,bnk->btn", logprobs,
                                 one_hot).transpose(0, 1)
    phi = torch.full((B, N + 1), log_epsilon, device=logits.device)
    phi[:, 0] = 0.0
    emit = torch.full((B, N), log_epsilon, device=logits.device)

    def update_phi(p, added):
        return torch.cat([p[:, :1], torch.logaddexp(p[:, 1:], added)], -1)

    pads = logit_paddings.float().transpose(0, 1)
    for t in range(logits.shape[1]):
        prev_phi_orig = phi
        prev_phi = update_phi(phi, emit + log_epsilon * repeat)
        lp_emit, lp_phi = logprobs_emit[t], logprobs_phi[t]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + lp_emit,
                                    emit + lp_emit)
        next_phi = update_phi(prev_phi + lp_phi,
                              emit + lp_phi + log_epsilon * (1.0 - repeat))
        pad = pads[t][:, None]
        emit = pad * emit + (1.0 - pad) * next_emit
        phi = pad * prev_phi_orig + (1.0 - pad) * next_phi
    phi_last = update_phi(phi, emit)
    return -phi_last.gather(1, labellens[:, None])[:, 0]


class CTCCriterion(Criterion):
    """CTC loss for DS2 training, the mean over the batch of each row's
    loss; index ``blank_id`` is the blank."""

    def __init__(self, blank_id: int = 0):
        self.blank_id = blank_id

    def __call__(self, log_probs: torch.Tensor, labels: torch.Tensor,
                 logit_mask: Optional[torch.Tensor] = None,
                 label_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``logit_mask`` ``(B, T)`` / ``label_mask`` ``(B, N)``: 1.0 = a
        valid frame / label (the framework's convention); labels are
        right-padded."""
        B, T = log_probs.shape[:2]
        dev = log_probs.device
        labels = torch.as_tensor(labels, device=dev).long()
        logit_mask = (torch.ones((B, T), device=dev) if logit_mask is None
                      else torch.as_tensor(logit_mask, device=dev).float())
        label_mask = (torch.ones(labels.shape, device=dev)
                      if label_mask is None
                      else torch.as_tensor(label_mask, device=dev).float())
        # an alignment needs a frame a label, plus a blank between repeats
        repeats = ((labels[:, 1:] == labels[:, :-1])
                   & (label_mask[:, 1:] > 0)).sum(1)
        # torch's ctc_loss reads its lengths on the host: one copy a call
        # brings them and the repeats back together
        in_len, lab_len, repeats = torch.stack(
            [logit_mask.sum(1).long(), label_mask.sum(1).long(),
             repeats]).cpu().numpy()
        lp = torch.log_softmax(log_probs.float(), -1)
        per_seq = F.ctc_loss(lp.transpose(0, 1), labels, in_len.tolist(),
                             lab_len.tolist(), blank=self.blank_id,
                             reduction="none", zero_infinity=True)
        infeasible = in_len < lab_len + repeats
        if infeasible.any():
            rows = torch.from_numpy(np.flatnonzero(infeasible)).to(dev)
            plain = ctc_loss_plain(log_probs[rows], 1.0 - logit_mask[rows],
                                   labels[rows], 1.0 - label_mask[rows],
                                   self.blank_id)
            per_seq = per_seq.index_put((rows,), plain)
        return per_seq.mean()
