"""Steps of the port; only inference so far."""

from analytics_zoo_tpu_torch.parallel.train import (make_eval_step,
                                                    resolve_compute_dtype)

__all__ = ["make_eval_step", "resolve_compute_dtype"]
