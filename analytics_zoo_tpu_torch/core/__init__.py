"""Layers of the port (PyTorch ``nn.Module``s)."""

from analytics_zoo_tpu_torch.core.criterion import CTCCriterion, Criterion
from analytics_zoo_tpu_torch.core.layers import CMul, Normalize, NormalizeScale
from analytics_zoo_tpu_torch.core.rnn import (BiRecurrent, GRUCell, LSTMCell,
                                              Recurrent, RnnCell)

__all__ = ["BiRecurrent", "CMul", "CTCCriterion", "Criterion", "GRUCell",
           "LSTMCell", "Normalize", "NormalizeScale", "Recurrent", "RnnCell"]
