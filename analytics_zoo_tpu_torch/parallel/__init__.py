"""Steps of the port: the train and eval steps, the one-device
``Optimizer``, optim methods and triggers."""

from analytics_zoo_tpu_torch.parallel.optim import (SGD, Adam, OptimMethod,
                                                    TrainingState, Trigger,
                                                    multistep)
from analytics_zoo_tpu_torch.parallel.train import (Optimizer, TrainState,
                                                    create_train_state,
                                                    make_eval_step,
                                                    make_train_step,
                                                    resolve_compute_dtype)

__all__ = ["Adam", "OptimMethod", "Optimizer", "SGD", "TrainState",
           "TrainingState", "Trigger", "create_train_state",
           "make_eval_step", "make_train_step", "multistep",
           "resolve_compute_dtype"]
