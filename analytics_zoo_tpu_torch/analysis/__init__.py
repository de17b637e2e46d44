"""az-analyze on the port: the two-engine invariant checker (counterpart
of ``analysis/``).

- **source engine** (:mod:`analysis.source`) — AST rules over the
  port's source.  No file is imported or executed; a rule sees the parse
  tree, the import-alias table, and the raw lines.  Exceptions are
  declared in-source with ``# az-allow: <rule> — <reason>`` — visible,
  reasoned, and counted, never silent (:mod:`analysis.base`).
- **program engine** (:mod:`analysis.program`) — every registered
  pipeline's train/eval step and the serving tiers' programs
  (:mod:`analysis.targets`) run once under a dispatch recorder, the
  four kernels as one op each, and the recorded op stream is audited: no
  host round-trips in hot programs, the train state updated in place,
  no float64 values, and the collectives confined to the groups the
  pipeline's ``SpecSet`` mesh declares.

``python -m analytics_zoo_tpu_torch.tools.az_analyze --all`` runs both
engines and exits non-zero on any un-waived violation.
"""

from analytics_zoo_tpu_torch.analysis.base import (
    Violation,
    Waiver,
    apply_waivers,
    format_violation,
    parse_waivers,
)
from analytics_zoo_tpu_torch.analysis.source import (
    SOURCE_RULES,
    default_rules,
    run_source_engine,
)

__all__ = [
    "Violation",
    "Waiver",
    "apply_waivers",
    "format_violation",
    "parse_waivers",
    "SOURCE_RULES",
    "default_rules",
    "run_source_engine",
]
