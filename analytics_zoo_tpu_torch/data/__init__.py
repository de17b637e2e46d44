"""Host-side data plumbing of the port: record files and the native
reader and codecs, datasets, transformers, batching, the multiprocess
loader, device prefetch and the synthetic shapes dataset."""

from analytics_zoo_tpu_torch.data.bucket import (BucketBatcher, edge_for,
                                                 padding_efficiency)
from analytics_zoo_tpu_torch.data.dataset import (Batcher, DataSet,
                                                  default_collate,
                                                  pad_ragged)
from analytics_zoo_tpu_torch.data.parallel import (ParallelLoader,
                                                   elastic_resume_coordinates,
                                                   make_input_pipeline,
                                                   sample_rng, seed_rngs,
                                                   stable_seed)
from analytics_zoo_tpu_torch.data.prefetch import (PrefetchDataSet,
                                                   PrefetchWorkerDied,
                                                   device_prefetch,
                                                   overlap_window)
from analytics_zoo_tpu_torch.data.records import (ReadStats, RecordWriter,
                                                  SSDByteRecord,
                                                  ShardReadError,
                                                  read_records,
                                                  read_ssd_records,
                                                  shard_paths,
                                                  write_ssd_records)
from analytics_zoo_tpu_torch.data.synthetic import (SHAPE_CLASSES,
                                                    generate_shapes_records,
                                                    render_shapes_image)
from analytics_zoo_tpu_torch.data.transformer import (ChainedTransformer,
                                                      FnTransformer,
                                                      ParallelTransformer,
                                                      Pipeline,
                                                      RandomTransformer,
                                                      ShuffleBuffer,
                                                      Transformer,
                                                      sample_random)

__all__ = [k for k in dir() if not k.startswith("_")]
