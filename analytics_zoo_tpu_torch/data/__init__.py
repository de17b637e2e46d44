"""Host-side data plumbing of the port; only the serving window so far."""

from analytics_zoo_tpu_torch.data.prefetch import overlap_window

__all__ = ["overlap_window"]
