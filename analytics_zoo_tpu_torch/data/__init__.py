"""Host-side data plumbing of the port: the serving window, and the
datasets, transformers and bucketed batching of the DS2 training set."""

from analytics_zoo_tpu_torch.data.bucket import (BucketBatcher, edge_for,
                                                 padding_efficiency)
from analytics_zoo_tpu_torch.data.dataset import (Batcher, DataSet,
                                                  default_collate,
                                                  pad_ragged)
from analytics_zoo_tpu_torch.data.prefetch import overlap_window
from analytics_zoo_tpu_torch.data.transformer import (FnTransformer,
                                                      Transformer)

__all__ = ["Batcher", "BucketBatcher", "DataSet", "FnTransformer",
           "Transformer", "default_collate", "edge_for", "overlap_window",
           "pad_ragged", "padding_efficiency"]
