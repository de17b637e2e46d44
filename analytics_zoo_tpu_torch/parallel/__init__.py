"""Steps of the port: the train and eval steps, the one-device
``Optimizer`` with its validation methods, checkpoints and resume, optim
methods, Plateau, triggers, the row-sparse Adam apply and the restart
supervisor."""

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
from analytics_zoo_tpu_torch.resilience.errors import (InjectedFault,
                                                       Preempted,
                                                       PrefetchWorkerDied,
                                                       ShardReadError,
                                                       StallError,
                                                       TrainingDiverged)

__all__ = ["Adam", "AdamW", "DivergenceDetector", "FaultInjector",
           "InjectedFault", "Loss", "MAE", "OptimMethod", "Optimizer",
           "Plateau", "Preempted", "PrefetchWorkerDied", "RETRYABLE_ERRORS",
           "SGD", "ShardReadError", "StallError", "Top1Accuracy",
           "TrainState", "TrainingDiverged", "TrainingState", "Trigger",
           "ValidationMethod", "ValidationResult",
           "cast_floating", "create_train_state", "make_eval_step",
           "make_train_step", "multistep", "resolve_compute_dtype",
           "run_resilient", "sparse_adam_apply", "validate"]
