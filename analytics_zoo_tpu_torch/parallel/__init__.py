"""Steps of the port: the train and eval steps, the one-device
``Optimizer`` with its validation methods, optim methods, Plateau,
triggers and the row-sparse Adam apply."""

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

__all__ = ["Adam", "AdamW", "Loss", "MAE", "OptimMethod", "Optimizer",
           "Plateau", "SGD", "Top1Accuracy", "TrainState", "TrainingState",
           "Trigger", "ValidationMethod", "ValidationResult",
           "cast_floating", "create_train_state", "make_eval_step",
           "make_train_step", "multistep", "resolve_compute_dtype",
           "sparse_adam_apply", "validate"]
