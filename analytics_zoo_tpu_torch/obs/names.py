"""The metric-name catalog (counterpart of ``obs/names.py``): every
name the port registers into a
:class:`~analytics_zoo_tpu_torch.obs.registry.MetricRegistry`, declared
once with its kind and one line of meaning.

The catalog is the reference's, entry for entry, so that a dashboard or
a scrape config written against one package reads the other.  Names
follow ``<subsystem>/<metric>[/k=v...]``: trailing ``k=v`` segments
become Prometheus labels, and a trailing ``*`` in an entry marks a
labeled family.  :func:`lookup` says whether a concrete name is
declared.  Some entries name parts the port does not run yet (the
autoscaler, the device-health sentinel); they stay so that the two
catalogs are equal.

Entries map name (or ``...=*`` family pattern) → ``"<kind> · <doc>"``.
"""

from __future__ import annotations

from typing import Dict

CATALOG: Dict[str, str] = {
    # -- serving (ServingMetrics, fed by ServingRuntime) --------------------
    "serve/submitted":
        "counter · requests submitted to the runtime (admitted or shed "
        "at the door)",
    "serve/completed":
        "counter · requests that reached a device and returned a result",
    "serve/failed":
        "counter · requests failed after exhausting replica failover",
    "serve/batches":
        "counter · batches dispatched to the replica pool",
    "serve/redispatches":
        "counter · batches re-dispatched exactly once after a replica "
        "fence",
    "serve/deadline_misses_completed_late":
        "counter · completed requests whose result landed past the "
        "deadline",
    "serve/shed/cause=*":
        "counter · requests shed before device dispatch, by cause "
        "(queue_full | deadline)",
    "serve/latency_s/tier=*":
        "histogram · end-to-end request latency per degradation tier",
    "serve/batch_fill":
        "histogram · dispatched-batch fill fraction (n_valid/max_batch)",
    "serve/queue_depth":
        "histogram · admission-queue depth sampled at each dispatch",
    # -- multiplexed fleet (ServingRuntime(models=...)) -----------------------
    "serve/submitted/model=*":
        "counter · requests submitted per multiplexed model",
    "serve/completed/model=*":
        "counter · requests completed per multiplexed model",
    "serve/failed/model=*":
        "counter · requests failed per multiplexed model",
    "serve/shed/model=*":
        "counter · requests shed per multiplexed model, by cause "
        "(model= then cause= labels)",
    "serve/deadline_misses_completed_late/model=*":
        "counter · completed-late requests per multiplexed model",
    "serve/latency_s/model=*":
        "histogram · end-to-end request latency per (model, tier)",
    "serve/model_weight/model=*":
        "gauge · weighted-EDF dispatch weight per model (1 = plain EDF; "
        "follows the model's worst fast-window SLO burn)",
    "serve/sessions/opened":
        "counter · streaming sessions opened (session-affine scheduling)",
    "serve/sessions/closed":
        "counter · streaming sessions closed (final chunk or state loss)",
    "serve/sessions_open":
        "gauge · streaming sessions currently open",
    "serve/cold_compiles":
        "counter · dispatches that paid the cold-compile tax (a replica "
        "served a geometry it had never compiled — what pre-warm deletes)",
    # -- live-weight hot-swap + canary (ServingRuntime.hot_swap) ------------
    "serve/swap/rollouts":
        "counter · hot-swap rollouts started (checkpoint verified, "
        "canary stage armed)",
    "serve/swap/replicas_swapped":
        "counter · replicas drained, re-installed with new weights and "
        "rejoined during rollouts",
    "serve/swap/rollbacks":
        "counter · rollouts reverted to the serve-lkg checkpoint tier "
        "(tripped canary or mid-rollout anomaly; exactly once each)",
    "serve/swap/lkg_promotions":
        "counter · serving last-known-good promotions after fully "
        "healthy rollouts (the hysteresis mirror of train LKG)",
    "serve/canary/mirrored/model=*":
        "counter · live requests mirrored to the canary weights per "
        "model (seeded fraction; never counted in accounting())",
    "serve/canary/divergence/model=*":
        "histogram · per-row output divergence between live and canary "
        "weights, labeled model= and swap= (rollout index)",
    "serve/canary/latency_s/model=*":
        "histogram · modeled service latency of the canary tier, "
        "labeled model= and swap= (rollout index)",
    "serve/canary/trips":
        "counter · canary stages tripped over their divergence/latency "
        "budgets (each one triggers a rollback)",
    # -- autoscaler (serving.autoscale.Autoscaler) --------------------------
    "autoscale/replicas":
        "gauge · current (or just-actuated target) replica-pool size",
    "autoscale/grow":
        "counter · pool-growth actuations taken by the policy loop",
    "autoscale/shrink":
        "counter · drain-then-retire shrink actuations taken",
    "autoscale/reshape":
        "counter · width-vs-count reshape actuations: a batch-saturated "
        "model's tier ladder swapped onto wider mesh slices instead of "
        "adding replicas (the B/128 occupancy-knee rationale)",
    # -- elastic mesh (parallel.train Optimizer elastic resume) -------------
    "elastic/restores":
        "counter · checkpoint restores re-placed onto a different world "
        "width than they were saved at",
    "elastic/world_width":
        "gauge · data-axis width the last elastic restore re-placed "
        "onto",
    # -- device health (resilience.health.HealthSentinel(registry=)) --------
    "health/audits":
        "counter · cross-replica parity audits run (per-replica param "
        "fingerprints compared at the decision boundary)",
    "health/audit_divergences":
        "counter · audits whose replica fingerprints disagreed (proven "
        "silent data corruption)",
    "health/shadow_checks":
        "counter · shadow recomputes run (sampled microbatch forward "
        "re-executed on a second device)",
    "health/shadow_mismatches":
        "counter · shadow recomputes disagreeing with the primary",
    "health/straggler_flags":
        "counter · devices flagged by the step-time EWMA hysteresis "
        "ladder as persistent stragglers",
    "health/quarantines":
        "counter · devices quarantined (training eviction raised or "
        "serving replica drained with device_budget decremented)",
    # -- SLO engine (obs.slo.SloEvaluator(registry=)) -----------------------
    "slo/fast_burn/slo=*":
        "gauge · latest fast-window burn rate per SLO (1.0 = budget "
        "consumed exactly at the sustainable rate)",
    "slo/slow_burn/slo=*":
        "gauge · latest slow-window burn rate per SLO",
    "slo/trips/slo=*":
        "counter · rising-edge transitions into burning per SLO (the "
        "fast-window trips the drill banks)",
    # -- training (Optimizer.set_observability) -----------------------------
    "train/dispatch/step_s":
        "histogram · host interval of the train-step call (async "
        "dispatch latency, not fenced device wall)",
    "train/dispatch/steps":
        "counter · train steps dispatched",
    "train/dispatch/records":
        "counter · training records dispatched",
    "train/anomaly/bad_steps":
        "counter · steps the anomaly sentinel discarded in-graph",
    "train/anomaly/rollbacks":
        "counter · last-known-good rollbacks the anomaly ladder took",
    "checkpoint/save_s":
        "histogram · checkpoint save wall seconds (sha256-manifested "
        "atomic publish)",
    "checkpoint/restore_s":
        "histogram · checkpoint restore wall seconds",
    # -- embedding lookups (ops.embedding.publish_lookup_stats) -------------
    "embed/lookups":
        "counter · id batches whose dedup stats were published",
    "embed/rows_touched":
        "gauge · unique table rows the last id batch gathered (what the "
        "dedup'd lookup actually fetches; the sparse apply's row count)",
    "embed/unique_fraction":
        "gauge · unique/total id ratio of the last batch (the dedup "
        "win: Zipfian traffic sits well below 1.0)",
    # -- data loading (ReadStats.publish) -----------------------------------
    "data/read/records":
        "gauge · records successfully yielded by resilient shard reads",
    "data/read/retries":
        "gauge · transient I/O errors retried",
    "data/read/skipped_records":
        "gauge · undecodable records dropped (skip-and-count)",
    "data/read/skipped_shards":
        "gauge · whole shards dropped after retry exhaustion",
    # -- step decomposition probe (obs.StepProbe) ---------------------------
    "probe/input_wait_s":
        "histogram · per-step blocking time on the input pipeline",
    "probe/dispatch_s":
        "histogram · per-step host dispatch time (call until return)",
    "probe/device_s":
        "histogram · per-step device wait (return until "
        "block_until_ready)",
}


def lookup(name: str) -> bool:
    """Whether a concrete registry name is covered by the catalog —
    exact entry, or a ``...=*`` family whose prefix matches."""
    if name in CATALOG:
        return True
    for pattern in CATALOG:
        if pattern.endswith("*") and name.startswith(pattern[:-1]):
            return True
    return False
