"""The autoscaler's shared definitions (counterpart of
``serving/autoscale.py``): the width-grow decision :class:`Reshape` and
the occupancy knee its rationale names.  The policy loop
(``AutoscalePolicy``, ``Autoscaler``) that turns the SLO engine's
``scale_hint`` into ``ReplicaPool.resize`` calls is ROADMAP.md Queue 1
item 13.
"""

from __future__ import annotations

import dataclasses

#: the per-device batch past which the reference's serving matmuls stop
#: gaining from more batch (its accelerator's 128-wide matrix unit); not
#: measured on a GPU
OCCUPANCY_KNEE = 128


@dataclasses.dataclass(frozen=True)
class Reshape:
    """The width-grow decision: move ``model``'s tier ladder from
    width-``from_width`` replicas onto width-``to_width`` ones instead
    of adding more narrow replicas, taken when the batch-fill EWMA
    (``fill``) shows the model batch-saturated.  ``rationale`` records
    the occupancy arithmetic behind it."""

    model: str
    from_width: int
    to_width: int
    fill: float
    rationale: str
