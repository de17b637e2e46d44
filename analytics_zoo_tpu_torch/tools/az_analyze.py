#!/usr/bin/env python
"""az-analyze on the port: the two-engine invariant checker.

Source engine — AST rules over ``analytics_zoo_tpu_torch/`` (one-clock,
one-placement-site, seeded-rng-only, no-host-sync-in-hot-path,
taxonomy-complete, registered-metric-names), with in-source
``# az-allow: <rule> — <reason>`` waivers.  Program engine — every
registered pipeline's train/eval step and every serving tier's program
run once under a dispatch recorder, the four kernels as one op each, and
audited (host round-trips, the train state updated in place, float64,
collectives over the groups the declared SpecSet mesh has).

Usage::

    python -m analytics_zoo_tpu_torch.tools.az_analyze --all --device cpu
    python -m analytics_zoo_tpu_torch.tools.az_analyze --source
    python -m analytics_zoo_tpu_torch.tools.az_analyze --program
    python -m analytics_zoo_tpu_torch.tools.az_analyze --list-rules

The programs run on ``--device`` (``cuda`` by default; the CPU only when
asked).  On ``cuda`` the sync debug mode is armed while each program
runs.  Diagnostics print one per line as ``file:line rule message``
(program findings as ``program:<target>:0 …``); applied waivers print
with their reasons — counted, never silent.  The summary line names each
kernel-bearing target with the kernel ops it recorded.  Exit status 1 on
any un-waived violation, 0 on a clean run.
"""

import argparse
import sys
import time


def kernel_summary(results) -> str:
    """``target=K1+K3 …`` for every target that recorded a kernel op."""
    return " ".join(f"{name}={'+'.join(sorted(r.kernels))}"
                    for name, r in results.items() if r.kernels)


def main(argv=None, results=None) -> int:
    """Run the CLI; ``results`` (optional dict) receives each audited
    target's ``AuditResult`` by name."""
    p = argparse.ArgumentParser(
        prog="az_analyze", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", action="store_true",
                   help="run the AST source engine")
    p.add_argument("--program", action="store_true",
                   help="run the program engine")
    p.add_argument("--all", action="store_true",
                   help="run both engines")
    p.add_argument("--root", default=None,
                   help="source-scan root (default: the installed "
                        "analytics_zoo_tpu_torch package)")
    p.add_argument("--device", default="cuda",
                   help="where the programs run (default: cuda)")
    p.add_argument("--list-rules", action="store_true",
                   help="print the source-rule catalog and exit")
    args = p.parse_args(argv)

    from analytics_zoo_tpu_torch.analysis import (SOURCE_RULES,
                                                  format_violation,
                                                  run_source_engine)

    if args.list_rules:
        for name, rule in sorted(SOURCE_RULES.items()):
            doc = " ".join((rule.__doc__ or "").split())
            print(f"{name}: {doc}")
        return 0

    run_source = args.source or args.all
    run_program = args.program or args.all
    if not (run_source or run_program):
        p.error("pick an engine: --source, --program, or --all")

    t0 = time.perf_counter()
    violations = []
    results = {} if results is None else results
    if run_source:
        violations += run_source_engine(root=args.root)
    if run_program:
        from analytics_zoo_tpu_torch.analysis.program import (
            run_program_engine)
        from analytics_zoo_tpu_torch.analysis.targets import repo_audit_suite
        from analytics_zoo_tpu_torch.utils import engine

        engine.init(engine.EngineConfig(device=args.device))
        violations += run_program_engine(
            repo_audit_suite(device=args.device), results)

    unwaived = [v for v in violations if not v.waived]
    waived = [v for v in violations if v.waived]
    for v in unwaived:
        print(format_violation(v))
    for v in waived:
        print(format_violation(v))
    dt = time.perf_counter() - t0
    engines = "+".join(e for e, on in (("source", run_source),
                                       ("program", run_program)) if on)
    kernels = kernel_summary(results)
    print(f"az-analyze [{engines}]: {len(unwaived)} violation(s), "
          f"{len(waived)} waived, {len(results)} program(s) audited "
          f"in {dt:.1f}s" + (f"; kernels: {kernels}" if kernels else ""))
    return 1 if unwaived else 0


if __name__ == "__main__":
    sys.exit(main())
