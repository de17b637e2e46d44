"""Steps of the port: the train and eval steps, the ``Optimizer`` (one
device, or a mesh of ranks) with its validation methods, checkpoints and
resume, optim methods, Plateau, triggers, the row-sparse Adam apply, the
restart supervisor, the mesh, the tensor-parallel rules and the declared
specs, sequence, pipeline and expert parallelism, and the TensorBoard
summaries."""

from analytics_zoo_tpu_torch.parallel.elastic import (RETRYABLE_ERRORS,
                                                      DivergenceDetector,
                                                      FaultInjector,
                                                      run_resilient)
from analytics_zoo_tpu_torch.parallel.optim import (SGD, Adam, AdamW,
                                                    OptimMethod, Plateau,
                                                    TrainingState, Trigger,
                                                    multistep)
from analytics_zoo_tpu_torch.parallel.train import (MAE, Loss, Optimizer,
                                                    Top1Accuracy, TrainState,
                                                    ValidationMethod,
                                                    ValidationResult,
                                                    cast_floating,
                                                    create_train_state,
                                                    make_eval_step,
                                                    make_train_step,
                                                    resolve_compute_dtype,
                                                    sparse_adam_apply,
                                                    validate)
from analytics_zoo_tpu_torch.parallel.mesh import (DATA_AXIS, EXPERT_AXIS,
                                                   MODEL_AXIS, PIPE_AXIS,
                                                   SEQUENCE_AXIS,
                                                   PartitionSpec, batch_spec,
                                                   create_mesh, replicate,
                                                   shard_batch)
from analytics_zoo_tpu_torch.parallel.expert import (
    moe_apply_dense, moe_apply_expert_parallel, route_top1)
from analytics_zoo_tpu_torch.parallel.pipeline import (
    carrier_decay_mask, flatten_stage_params, flatten_stage_params_grouped,
    pipeline_forward, pipeline_forward_het, split_microbatches,
    stack_stage_params, stage_carrier_slice, unflatten_stage)
from analytics_zoo_tpu_torch.parallel.summary import (TrainSummary,
                                                      ValidationSummary)
from analytics_zoo_tpu_torch.parallel.specs import (SpecSet, pipeline_specs,
                                                    register_pipeline,
                                                    registered_pipelines)
from analytics_zoo_tpu_torch.parallel.tensor import (default_tp_rules,
                                                     embedding_row_rules,
                                                     megatron_tp_rules,
                                                     shard_tree,
                                                     sharded_param_count,
                                                     spatial_input_spec,
                                                     ssd_tp_rules)
from analytics_zoo_tpu_torch.resilience.anomaly import AnomalyPolicy
from analytics_zoo_tpu_torch.resilience.errors import (ElasticPlacementError,
                                                       InjectedFault,
                                                       Preempted,
                                                       PrefetchWorkerDied,
                                                       ShardReadError,
                                                       StallError,
                                                       TrainingDiverged)

__all__ = ["Adam", "AdamW", "AnomalyPolicy", "DATA_AXIS",
           "DivergenceDetector", "TrainSummary", "ValidationSummary",
           "EXPERT_AXIS", "ElasticPlacementError", "FaultInjector",
           "MODEL_AXIS", "PIPE_AXIS", "PartitionSpec", "SEQUENCE_AXIS",
           "SpecSet", "batch_spec", "carrier_decay_mask",
           "flatten_stage_params", "flatten_stage_params_grouped",
           "moe_apply_dense", "moe_apply_expert_parallel",
           "pipeline_forward", "pipeline_forward_het", "route_top1",
           "split_microbatches", "stack_stage_params",
           "stage_carrier_slice", "unflatten_stage",
           "create_mesh", "default_tp_rules", "embedding_row_rules",
           "megatron_tp_rules", "pipeline_specs", "register_pipeline",
           "registered_pipelines", "replicate", "shard_batch", "shard_tree",
           "sharded_param_count", "spatial_input_spec", "ssd_tp_rules",
           "InjectedFault", "Loss", "MAE", "OptimMethod", "Optimizer",
           "Plateau", "Preempted", "PrefetchWorkerDied", "RETRYABLE_ERRORS",
           "SGD", "ShardReadError", "StallError", "Top1Accuracy",
           "TrainState", "TrainingDiverged", "TrainingState", "Trigger",
           "ValidationMethod", "ValidationResult",
           "cast_floating", "create_train_state", "make_eval_step",
           "make_train_step", "multistep", "resolve_compute_dtype",
           "run_resilient", "sparse_adam_apply", "validate"]
