"""Layers of the port (PyTorch ``nn.Module``s)."""

from analytics_zoo_tpu_torch.core.criterion import (
    BCECriterion, ClassNLLCriterion, CrossEntropyCriterion, CTCCriterion,
    Criterion, MSECriterion, ParallelCriterion, SmoothL1Criterion, smooth_l1)
from analytics_zoo_tpu_torch.core.layers import CMul, Normalize, NormalizeScale
from analytics_zoo_tpu_torch.core.rnn import (BiRecurrent, GRUCell, LSTMCell,
                                              Recurrent, RnnCell)

__all__ = ["BCECriterion", "BiRecurrent", "CMul", "CTCCriterion",
           "ClassNLLCriterion", "Criterion", "CrossEntropyCriterion",
           "GRUCell", "LSTMCell", "MSECriterion", "Normalize",
           "NormalizeScale", "ParallelCriterion", "Recurrent", "RnnCell",
           "SmoothL1Criterion", "smooth_l1"]
