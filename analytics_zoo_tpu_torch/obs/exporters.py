"""Exporters (counterpart of ``obs/exporters.py``): one registry and
recorder, three outputs.

- :func:`dump_flight_jsonl`: the black-box JSONL file;
- :func:`render_prometheus`: Prometheus text exposition of a
  :class:`~analytics_zoo_tpu_torch.obs.registry.MetricRegistry`;
- :class:`SummaryBridge`: registry values into a
  ``parallel/summary.py`` TensorBoard writer, under its per-tag
  triggers.

Trailing ``k=v`` path segments become Prometheus labels:
``serve/latency_s/tier=0`` renders as ``serve_latency_s{tier="0"}``.
"""

from __future__ import annotations

import re
from typing import List, Tuple

from analytics_zoo_tpu_torch.obs.recorder import FlightRecorder
from analytics_zoo_tpu_torch.obs.registry import MetricRegistry

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def dump_flight_jsonl(recorder: FlightRecorder, path: str,
                      reason: str = "export") -> str:
    """Write the recorder ring to ``path`` as JSONL; returns the text."""
    return recorder.dump(reason, path=path)


def _escape_label(v: str) -> str:
    """Label-value escaping of the text format: backslash, double quote
    and newline; anything else passes as it is."""
    return (v.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_name(name: str) -> Tuple[str, str]:
    """A registry name → (Prometheus name, label block)."""
    parts = name.split("/")
    labels = []
    while parts and "=" in parts[-1]:
        k, v = parts.pop().split("=", 1)
        labels.append((_NAME_RE.sub("_", k), _escape_label(v)))
    base = _NAME_RE.sub("_", "_".join(parts)) or "metric"
    if base[0].isdigit():
        base = "_" + base
    block = ("{" + ",".join(f'{k}="{v}"' for k, v in sorted(labels)) + "}"
             if labels else "")
    return base, block


#: the series each kind emits, by suffix
_EMITTED = {"counter": ("_total",), "gauge": ("",),
            "histogram": ("", "_sum", "_count")}


def render_prometheus(registry: MetricRegistry) -> str:
    """Prometheus text format: counters and gauges as one sample each,
    histograms as ``_count``/``_sum`` and p50/p99 quantiles of the
    reservoir (``NaN`` while it is empty).  Names that differ only in
    their ``k=v`` segments are one family, under one ``# TYPE`` line.
    Two registry names that would emit the same series (sanitizing is
    lossy, and the suffixes can alias a neighbour) raise."""
    def fmt(v) -> str:
        if v is None:
            return "NaN"
        return repr(float(v))

    families: "dict[tuple, List[str]]" = {}
    seen: "dict[Tuple[str, str], str]" = {}
    for name, m in registry.metrics().items():
        base, labels = _prom_name(name)
        for suffix in _EMITTED[m.kind]:
            prior = seen.setdefault((base + suffix, labels), name)
            if prior != name:
                raise ValueError(
                    f"prometheus name collision: registry names "
                    f"{prior!r} and {name!r} both emit the series "
                    f"{base + suffix}{labels or ''} — rename one "
                    f"(sanitization must stay injective per sample)")
        fam = families.setdefault((base, m.kind), [])
        if m.kind == "counter":
            fam.append(f"{base}_total{labels} {m.value}")
        elif m.kind == "gauge":
            fam.append(f"{base}{labels} {fmt(m.value)}")
        else:
            snap = m.snapshot()
            inner = labels[1:-1] if labels else ""
            for q, key in (("0.5", "p50"), ("0.99", "p99")):
                lab = "{" + (inner + "," if inner else "") + \
                    f'quantile="{q}"' + "}"
                fam.append(f"{base}{lab} {fmt(snap[key])}")
            fam.append(f"{base}_sum{labels} {fmt(snap['sum'])}")
            fam.append(f"{base}_count{labels} {snap['count']}")
    lines: List[str] = []
    for (base, kind), fam in families.items():
        # a counter family's exposition name is its _total series
        tname = base + "_total" if kind == "counter" else base
        ttype = "summary" if kind == "histogram" else kind
        lines.append(f"# TYPE {tname} {ttype}")
        lines.extend(fam)
    return "\n".join(lines) + ("\n" if lines else "")


class SummaryBridge:
    """Feed a registry into a ``parallel.summary`` writer:
    ``export(registry, iteration)`` writes every counter and gauge as a
    scalar and every histogram's mean and p99, tagged by the registry
    names.  The summary's per-tag triggers gate the writes."""

    def __init__(self, summary):
        self.summary = summary

    def export(self, registry: MetricRegistry, iteration: int) -> None:
        for name, m in registry.metrics().items():
            if m.kind in ("counter", "gauge"):
                if m.value is not None:
                    self.summary.add_scalar(name, m.value, iteration)
            else:
                snap = m.snapshot()
                if snap["count"]:
                    self.summary.add_scalar(f"{name}/mean", snap["mean"],
                                            iteration)
                    self.summary.add_scalar(f"{name}/p99", snap["p99"],
                                            iteration)
