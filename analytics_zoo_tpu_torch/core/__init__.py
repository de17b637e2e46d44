"""Layers of the port (PyTorch ``nn.Module``s), the containers and the
``Model`` wrapper."""

from analytics_zoo_tpu_torch.core.criterion import (
    BCECriterion, ClassNLLCriterion, CrossEntropyCriterion, CTCCriterion,
    Criterion, MSECriterion, ParallelCriterion, SmoothL1Criterion, smooth_l1)
from analytics_zoo_tpu_torch.core.layers import CMul, Normalize, NormalizeScale
from analytics_zoo_tpu_torch.core.module import (
    CAddTable, ConcatTable, FlattenTable, Identity, JoinTable, Lambda, Model,
    Module, ParallelTable, SelectTable, Sequential, accepted_kwargs)
from analytics_zoo_tpu_torch.core.rnn import (BiRecurrent, GRUCell, LSTMCell,
                                              Recurrent, RnnCell)

__all__ = ["BCECriterion", "BiRecurrent", "CAddTable", "CMul",
           "CTCCriterion", "ClassNLLCriterion", "ConcatTable", "Criterion",
           "CrossEntropyCriterion", "FlattenTable", "GRUCell", "Identity",
           "JoinTable", "LSTMCell", "Lambda", "MSECriterion", "Model",
           "Module", "Normalize", "NormalizeScale", "ParallelCriterion",
           "ParallelTable", "Recurrent", "RnnCell", "SelectTable",
           "Sequential", "SmoothL1Criterion", "accepted_kwargs",
           "smooth_l1"]
