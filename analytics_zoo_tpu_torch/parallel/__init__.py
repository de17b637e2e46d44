"""Steps of the port: the train and eval steps, the one-device
``Optimizer`` with its validation, optim methods, Plateau and
triggers."""

from analytics_zoo_tpu_torch.parallel.optim import (SGD, Adam, AdamW,
                                                    OptimMethod, Plateau,
                                                    TrainingState, Trigger,
                                                    multistep)
from analytics_zoo_tpu_torch.parallel.train import (Optimizer, TrainState,
                                                    ValidationMethod,
                                                    ValidationResult,
                                                    cast_floating,
                                                    create_train_state,
                                                    make_eval_step,
                                                    make_train_step,
                                                    resolve_compute_dtype,
                                                    validate)

__all__ = ["Adam", "AdamW", "OptimMethod", "Optimizer", "Plateau", "SGD",
           "TrainState", "TrainingState", "Trigger", "ValidationMethod",
           "ValidationResult", "cast_floating", "create_train_state",
           "make_eval_step", "make_train_step", "multistep",
           "resolve_compute_dtype", "validate"]
