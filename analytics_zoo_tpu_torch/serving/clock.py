"""The serving runtime's clock: a re-export of
:mod:`analytics_zoo_tpu_torch.utils.clock`, so that
``from analytics_zoo_tpu_torch.serving.clock import VirtualClock`` works
as the reference's import does."""

from analytics_zoo_tpu_torch.utils.clock import (  # noqa: F401
    Clock,
    MonotonicClock,
    VirtualClock,
    as_now_fn,
)

__all__ = ["Clock", "MonotonicClock", "VirtualClock", "as_now_fn"]
