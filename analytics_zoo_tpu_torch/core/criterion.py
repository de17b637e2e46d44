"""Criterions of the port (counterpart of ``core/criterion.py``): only
what the DS2 training slice uses so far, ``Criterion`` and
``CTCCriterion``.

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

from typing import Optional

import torch
import torch.nn.functional as F


class Criterion:
    """Base class; subclasses implement ``__call__(input, target) ->
    scalar``."""

    def __call__(self, inputs, target):  # pragma: no cover - interface
        raise NotImplementedError


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
        in_len = logit_mask.sum(1).long()
        lab_len = label_mask.sum(1).long()
        lp = torch.log_softmax(log_probs.float(), -1)
        per_seq = F.ctc_loss(lp.transpose(0, 1), labels, in_len, lab_len,
                             blank=self.blank_id, reduction="none",
                             zero_infinity=True)
        # an alignment needs a frame a label, plus a blank between repeats
        repeats = ((labels[:, 1:] == labels[:, :-1])
                   & (label_mask[:, 1:] > 0)).sum(1)
        infeasible = in_len < lab_len + repeats
        if bool(infeasible.any()):
            rows = infeasible.nonzero()[:, 0]
            plain = ctc_loss_plain(log_probs[rows], 1.0 - logit_mask[rows],
                                   labels[rows], 1.0 - label_mask[rows],
                                   self.blank_id)
            per_seq = per_seq.index_put((rows,), plain)
        return per_seq.mean()
