"""Source engine: AST rules encoding the port's invariants (counterpart
of ``analysis/source.py``).

Each rule is a small object with a ``name``, a one-line ``doc``, and a
``check(ctx)`` generator over :class:`~analytics_zoo_tpu_torch.analysis.
base.Violation`.  The engine parses every package module ONCE into a
:class:`ModuleContext` (AST + import-alias table + raw lines — nothing
is imported or executed, so a rule can never be dodged by import-time
side effects) and runs every rule over it, then applies the in-source
``az-allow`` waivers.

Adding a rule:

1. subclass/instantiate with a unique kebab-case ``name``;
2. yield ``Violation``\\ s with the *package-relative* file path the
   engine passed in ``ctx.display``;
3. append the instance to :data:`SOURCE_RULES`;
4. add the firing + clean fixture pair in ``tests/test_torch_analyze.py``.

The rule names and their meanings are the reference's, read in
PyTorch's idiom: ``one-placement-site`` bans building a ``DeviceMesh``
and the placement calls the port's substrate wraps; ``seeded-rng-only``
adds torch's global generator; ``no-host-sync-in-hot-path`` flags
``.item()`` and the CUDA synchronize calls.  The rules resolve import
aliases (``import numpy as np``, ``import time as _time``, ``from
torch.distributed.device_mesh import DeviceMesh``) so renamed imports
cannot slip past a textual match.
"""

from __future__ import annotations

import ast
import dataclasses
import os
from typing import Dict, FrozenSet, Iterator, List, Optional, Sequence

from analytics_zoo_tpu_torch.analysis.base import (
    Violation,
    apply_waivers,
    parse_waivers,
)


@dataclasses.dataclass
class ModuleContext:
    """One parsed module: package-relative path, AST, raw lines, and the
    local-name → dotted-origin import table."""

    rel: str              # posix path relative to the scan root
    display: str          # path used in diagnostics (root name + rel)
    tree: ast.Module
    lines: List[str]
    aliases: Dict[str, str]

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted origin of a Name/Attribute chain, through the alias
        table: ``np.random.seed`` → ``numpy.random.seed``,
        ``_time.monotonic`` → ``time.monotonic``, a bare ``DeviceMesh``
        imported from ``torch.distributed.device_mesh`` →
        ``torch.distributed.device_mesh.DeviceMesh``."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        parts.append(node.id)
        parts.reverse()
        head = parts[0]
        if head in self.aliases:
            return ".".join([self.aliases[head]] + parts[1:])
        return ".".join(parts)


def _import_aliases(tree: ast.Module) -> Dict[str, str]:
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                local = a.asname or a.name.split(".")[0]
                # `import numpy.random` binds the TOP package name
                origin = a.name if a.asname else a.name.split(".")[0]
                aliases[local] = origin
        elif isinstance(node, ast.ImportFrom):
            mod = ("." * node.level) + (node.module or "")
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{mod}.{a.name}" if mod \
                    else a.name
    return aliases


def _calls(tree: ast.Module) -> Iterator[ast.Call]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield node


def _last_component(ctx: ModuleContext, func: ast.AST) -> Optional[str]:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OneClock:
    """No ``time.time()``/``time.monotonic()`` outside the injected
    clock module — every time-based decision (deadlines, shedding,
    stall detection, span timestamps, epoch/eval throughput logs) must
    read the ONE clock so drills replay deterministically under
    ``VirtualClock``."""

    name: str = "one-clock"
    allowed: FrozenSet[str] = frozenset({"utils/clock.py"})
    _BANNED = frozenset({"time.time", "time.monotonic"})

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if ctx.rel in self.allowed:
            return
        for call in _calls(ctx.tree):
            r = ctx.resolve(call.func)
            if r in self._BANNED:
                yield Violation(
                    rule=self.name, file=ctx.display, line=call.lineno,
                    message=f"{r}() read outside utils/clock.py — inject "
                            f"a Clock/now-fn (utils.clock.as_now_fn) so "
                            f"virtual-clock drills stay deterministic")


@dataclasses.dataclass
class OnePlacementSite:
    """No device mesh built and no tensor placed over one outside the
    declare-once substrate (``parallel/specs.py`` and the mesh/tensor
    placement engines it delegates to): no ``DeviceMesh(`` or
    ``init_device_mesh(``, no ``shard_module(``/``shard_tree(`` (what
    ``SpecSet.place_state`` wraps), no ``Shard(`` record, and none of
    torch's own ``distribute_tensor``/``distribute_module``.  A plain
    ``.to(device)`` is not placement over a mesh and stays allowed."""

    name: str = "one-placement-site"
    allowed: FrozenSet[str] = frozenset({
        "parallel/specs.py",     # the declaration + its one payoff site
        "parallel/mesh.py",      # the mesh and the replicate engine
        "parallel/tensor.py",    # rule-resolved shard_module/shard_tree
    })
    _BANNED = frozenset({"DeviceMesh", "init_device_mesh", "shard_module",
                         "shard_tree", "Shard", "distribute_tensor",
                         "distribute_module"})

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if ctx.rel in self.allowed:
            return
        for call in _calls(ctx.tree):
            resolved = ctx.resolve(call.func)
            last = (resolved.rsplit(".", 1)[-1] if resolved
                    else _last_component(ctx, call.func))
            if last in self._BANNED:
                yield Violation(
                    rule=self.name, file=ctx.display, line=call.lineno,
                    message=f"{last}( places tensors over a mesh outside "
                            f"the spec layer — declare it in "
                            f"parallel/specs.py and consume the SpecSet")


#: numpy.random module-level draw/state functions (the GLOBAL RNG).
_NP_MODULE_DRAWS = frozenset({
    "rand", "randn", "randint", "random", "random_sample", "ranf",
    "sample", "choice", "bytes", "shuffle", "permutation", "uniform",
    "normal", "standard_normal", "beta", "binomial", "chisquare",
    "dirichlet", "exponential", "f", "gamma", "geometric", "gumbel",
    "hypergeometric", "laplace", "logistic", "lognormal", "logseries",
    "multinomial", "multivariate_normal", "negative_binomial",
    "noncentral_chisquare", "noncentral_f", "pareto", "poisson", "power",
    "rayleigh", "standard_cauchy", "standard_exponential",
    "standard_gamma", "standard_t", "triangular", "vonmises", "wald",
    "weibull", "zipf", "get_state", "set_state",
})

#: calls that seed or reseed torch's process-global generators
_TORCH_GLOBAL_SEEDS = frozenset({
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed", "torch.cuda.seed_all",
})

#: torch draws that read the global generator unless given ``generator=``
_TORCH_DRAWS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial", "poisson",
})

#: in-place tensor draws (and ``nn.init``'s, which end the same way)
_TORCH_INPLACE_DRAWS = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
})


@dataclasses.dataclass
class SeededRngOnly:
    """Determinism by construction: no global ``np.random.seed``, no
    module-level ``np.random.<draw>`` (both mutate/read process-global
    state any import can perturb — the exact hazard the loader's
    byte-identical-for-any-worker-count contract forbids), and no
    unseeded ``Generator``/``RandomState`` construction (randomness must
    derive from the (base_seed, epoch, index) chain, never the OS).
    torch's global generator likewise: no ``torch.manual_seed``/
    ``torch.seed``/``torch.cuda.manual_seed(_all)``, and no
    ``torch.rand``/``randn``/``randint``/``randperm``/``normal``/
    ``bernoulli``/``multinomial``/``poisson`` or in-place draw
    (``.uniform_``, ``.normal_``, ``.random_``, …) without a
    ``generator=``."""

    name: str = "seeded-rng-only"
    allowed: FrozenSet[str] = frozenset()
    #: constructors that draw OS entropy when called without a seed —
    #: the Generator front door, the legacy RandomState, every stock
    #: BitGenerator, and SeedSequence itself
    _SEEDABLE_CTORS = frozenset({
        "default_rng", "RandomState", "PCG64", "PCG64DXSM", "MT19937",
        "Philox", "SFC64", "SeedSequence",
    })

    @staticmethod
    def _unseeded_call(call: ast.Call) -> bool:
        """No arguments, or an explicit ``None``/``seed=None`` first
        seed — both fall back to OS entropy."""
        if not call.args and not call.keywords:
            return True
        if call.args:
            first = call.args[0]
        else:
            seed_kw = [k for k in call.keywords
                       if k.arg in ("seed", "entropy")]
            if not seed_kw:
                return False
            first = seed_kw[0].value
        return isinstance(first, ast.Constant) and first.value is None

    def _numpy(self, ctx: ModuleContext, call: ast.Call,
               r: str) -> Iterator[Violation]:
        tail = r.rsplit(".", 1)[1]
        if r == "numpy.random.seed":
            yield Violation(
                rule=self.name, file=ctx.display, line=call.lineno,
                message="np.random.seed mutates the process-global "
                        "RNG — thread a seeded np.random.Generator "
                        "instead (data.parallel seeding chain)")
        elif tail in _NP_MODULE_DRAWS:
            yield Violation(
                rule=self.name, file=ctx.display, line=call.lineno,
                message=f"np.random.{tail} draws from the process-"
                        f"global RNG — use a Generator seeded from "
                        f"the stream position")
        elif tail in self._SEEDABLE_CTORS and self._unseeded_call(call):
            yield Violation(
                rule=self.name, file=ctx.display, line=call.lineno,
                message=f"{tail}() without a seed draws OS entropy — "
                        f"derive the seed from the (base_seed, epoch, "
                        f"index) chain")

    def _torch(self, ctx: ModuleContext, call: ast.Call,
               r: Optional[str]) -> Iterator[Violation]:
        if r in _TORCH_GLOBAL_SEEDS:
            yield Violation(
                rule=self.name, file=ctx.display, line=call.lineno,
                message=f"{r} seeds torch's process-global generator — "
                        f"pass a torch.Generator().manual_seed(seed)")
            return
        if any(k.arg == "generator" for k in call.keywords):
            return
        last = _last_component(ctx, call.func)
        if r is not None and r.startswith("torch.") \
                and r.count(".") == 1 and last in _TORCH_DRAWS:
            yield Violation(
                rule=self.name, file=ctx.display, line=call.lineno,
                message=f"torch.{last} without generator= draws from "
                        f"torch's process-global generator — pass a "
                        f"seeded torch.Generator")
        elif isinstance(call.func, ast.Attribute) \
                and last in _TORCH_INPLACE_DRAWS:
            yield Violation(
                rule=self.name, file=ctx.display, line=call.lineno,
                message=f".{last}( without generator= draws from "
                        f"torch's process-global generator — pass a "
                        f"seeded torch.Generator")

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if ctx.rel in self.allowed:
            return
        for call in _calls(ctx.tree):
            r = ctx.resolve(call.func)
            if r is not None and r.startswith("numpy.random."):
                yield from self._numpy(ctx, call, r)
            else:
                yield from self._torch(ctx, call, r)


#: Modules on the step/dispatch hot path: the train step factories +
#: host loop, the serving dispatch chain, the two pipeline modules
#: whose serving programs feed the runtime, and the device-health
#: fingerprint programs (the parity audit's no-host-sync contract:
#: fingerprints fold on the device and are fetched only at the decision
#: boundary in the host loop).
_HOT_MODULES = frozenset({
    "parallel/train.py",
    "parallel/optim.py",
    "serving/replica.py",
    "serving/runtime.py",
    "serving/batcher.py",
    "serving/request.py",
    "pipelines/ssd.py",
    "pipelines/deepspeech2.py",
    "resilience/health.py",
})


@dataclasses.dataclass
class NoHostSyncInHotPath:
    """No host synchronization inside step/dispatch modules: every
    ``.item()``, ``torch.cuda.synchronize()`` and ``Event``/``Stream``
    ``.synchronize()`` is a full device round-trip that serializes the
    asynchronous launch queue.  The reference's second half (host
    materialisation inside a jit-bound function) has nothing to bind to
    here: the port has no jit (no ``torch.compile``, no CUDA graphs), and
    the program engine's host round-trip check (``analysis/program.py``)
    covers the same ground on the recorded programs.  The ONE sanctioned
    sync point is ``obs/probe.py`` — syncing is its measurement, by
    design."""

    name: str = "no-host-sync-in-hot-path"
    hot_modules: FrozenSet[str] = _HOT_MODULES
    allowed: FrozenSet[str] = frozenset({"obs/probe.py"})

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if ctx.rel in self.allowed or ctx.rel not in self.hot_modules:
            return
        for call in _calls(ctx.tree):
            last = _last_component(ctx, call.func)
            if last == "synchronize" and not call.args:
                what = ctx.resolve(call.func) or "synchronize"
                yield Violation(
                    rule=self.name, file=ctx.display, line=call.lineno,
                    message=f"{what}() in a hot-path module — syncing "
                            f"belongs to obs/probe.py (or waive with the "
                            f"reason the sync is load-bearing)")
            elif last == "item" and not call.args and not call.keywords:
                yield Violation(
                    rule=self.name, file=ctx.display, line=call.lineno,
                    message=".item() forces a device round-trip per "
                            "scalar in a hot-path module")


@dataclasses.dataclass
class TaxonomyComplete:
    """Every exception class in ``resilience/errors.py`` must appear in
    exactly one of ``_RETRYABLE_CLASSES``/``FATAL_ERRORS`` — an error
    class outside both falls through ``run_resilient``'s retry filter
    with unconsidered semantics (the retry contract, now static: the
    check runs without importing the module)."""

    name: str = "taxonomy-complete"
    target: str = "resilience/errors.py"
    registries: Sequence[str] = ("_RETRYABLE_CLASSES", "FATAL_ERRORS")

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if ctx.rel != self.target:
            return
        classes: Dict[str, int] = {}
        for node in ctx.tree.body:
            if isinstance(node, ast.ClassDef) and node.bases:
                classes[node.name] = node.lineno
        registered: Dict[str, int] = {}
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                target = node.targets[0].id
            elif isinstance(node, ast.AnnAssign) \
                    and isinstance(node.target, ast.Name):
                target = node.target.id
            else:
                continue
            if target not in self.registries:
                continue
            if isinstance(node.value, (ast.Tuple, ast.List)):
                for elt in node.value.elts:
                    if isinstance(elt, ast.Name):
                        registered[elt.id] = node.lineno
        for name, lineno in sorted(classes.items()):
            if name not in registered:
                yield Violation(
                    rule=self.name, file=ctx.display, line=lineno,
                    message=f"error class {name} is in neither "
                            f"_RETRYABLE_CLASSES nor FATAL_ERRORS — "
                            f"classify it so run_resilient's retry filter "
                            f"has considered semantics")
        for name, lineno in sorted(registered.items()):
            if name not in classes:
                yield Violation(
                    rule=self.name, file=ctx.display, line=lineno,
                    message=f"registry names {name}, which is not an "
                            f"exception class defined in this module")


@dataclasses.dataclass
class RegisteredMetricNames:
    """Every ``registry.counter/gauge/histogram`` name used anywhere in
    the package must be declared once in the ``obs/names.py`` catalog —
    the registry accepts free-form strings, which is exactly how five
    generations of telemetry names drifted apart.  The rule
    resolves statically: a literal name (or an f-string whose leading
    literal prefix pins the family, e.g. ``f"serve/latency_s/tier=
    {tier}"`` → ``serve/latency_s/tier=*``) must be covered by a
    catalog entry; a fully caller-parameterized name cannot be checked
    here and needs a reasoned ``# az-allow:`` waiver naming the
    canonical family it registers under (the standard waiver contract —
    the exemption is visible at the call site, and the catalog still
    documents the family).

    The catalog is read from the INSTALLED package's ``obs/names.py``
    by AST (``CATALOG`` dict-literal keys) — never imported, per the
    engine's no-execution discipline — so fixture scans of other roots
    still check against the real declaration."""

    name: str = "registered-metric-names"
    allowed: FrozenSet[str] = frozenset({
        "obs/registry.py",   # the substrate itself (names are params)
        "obs/names.py",      # the declaration
    })
    _METHODS = frozenset({"counter", "gauge", "histogram"})

    def _catalog(self) -> FrozenSet[str]:
        cached = getattr(self, "_catalog_cache", None)
        if cached is not None:
            return cached
        path = os.path.join(package_root(), "obs", "names.py")
        patterns: List[str] = []
        try:
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                target = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name):
                    target = node.targets[0].id
                elif isinstance(node, ast.AnnAssign) \
                        and isinstance(node.target, ast.Name):
                    target = node.target.id
                if target != "CATALOG" or not isinstance(node.value,
                                                         ast.Dict):
                    continue
                for key in node.value.keys:
                    if isinstance(key, ast.Constant) \
                            and isinstance(key.value, str):
                        patterns.append(key.value)
        except (OSError, SyntaxError):   # pragma: no cover - repo intact
            pass
        out = frozenset(patterns)
        self._catalog_cache = out
        return out

    @staticmethod
    def _static_name(arg: ast.AST):
        """(resolved-name-or-pattern, fully_static) from the first call
        argument; (None, False) when no literal prefix exists."""
        if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
            return arg.value, True
        if isinstance(arg, ast.JoinedStr):
            prefix: List[str] = []
            for part in arg.values:
                if isinstance(part, ast.Constant) \
                        and isinstance(part.value, str):
                    prefix.append(part.value)
                else:
                    break
            p = "".join(prefix)
            return (p + "*", False) if p else (None, False)
        return None, False

    def _covered(self, name: str) -> bool:
        cat = self._catalog()
        if name in cat:
            return True
        if name.endswith("*"):
            p = name[:-1]
            return any(c.endswith("*") and p.startswith(c[:-1])
                       for c in cat)
        return any(c.endswith("*") and name.startswith(c[:-1])
                   for c in cat)

    def check(self, ctx: ModuleContext) -> Iterator[Violation]:
        if ctx.rel in self.allowed:
            return
        for call in _calls(ctx.tree):
            if not isinstance(call.func, ast.Attribute) \
                    or call.func.attr not in self._METHODS:
                continue
            if not call.args:
                continue
            resolved, _ = self._static_name(call.args[0])
            if resolved is None:
                yield Violation(
                    rule=self.name, file=ctx.display, line=call.lineno,
                    message=f".{call.func.attr}( name is not statically "
                            f"resolvable — declare the canonical family "
                            f"in obs/names.py and waive this "
                            f"caller-parameterized site with the family "
                            f"it registers under")
            elif not self._covered(resolved):
                yield Violation(
                    rule=self.name, file=ctx.display, line=call.lineno,
                    message=f"metric name {resolved!r} is not declared "
                            f"in the obs/names.py catalog — declare it "
                            f"(name, kind, one-line meaning) so the "
                            f"registry namespace stays documented")


def default_rules() -> List:
    return [OneClock(), OnePlacementSite(), SeededRngOnly(),
            NoHostSyncInHotPath(), TaxonomyComplete(),
            RegisteredMetricNames()]


#: name → rule instance (the default catalog the CLI runs).
SOURCE_RULES: Dict[str, object] = {r.name: r for r in default_rules()}


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


PACKAGE = "analytics_zoo_tpu_torch"


def package_root() -> str:
    """The ``analytics_zoo_tpu_torch`` package directory (the default
    scan root)."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_py_files(root: str) -> Iterator[str]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fname in sorted(filenames):
            if fname.endswith(".py"):
                yield os.path.join(dirpath, fname)


def run_source_engine(root: Optional[str] = None,
                      rules: Optional[Sequence] = None) -> List[Violation]:
    """Parse every ``.py`` under ``root`` (default: the installed
    package), run every rule, apply waivers.  Returns ALL violations —
    waived ones carry ``waived=True``; callers gate on the un-waived
    subset.

    Rule path scopes (``allowed`` / ``hot_modules`` / ``target``) are
    PACKAGE-root-relative (``utils/clock.py``), so a ``root`` that
    merely *contains* the package (e.g. the repo checkout, ``--root .``)
    is normalized down to its ``analytics_zoo_tpu_torch/`` directory —
    scanning from the wrong altitude would silently void every exemption
    and flag the sanctioned modules themselves."""
    root = os.path.abspath(root or package_root())
    nested = os.path.join(root, PACKAGE)
    if os.path.basename(root) != PACKAGE \
            and os.path.isdir(nested):
        root = nested
    rules = list(rules) if rules is not None else default_rules()
    rootname = os.path.basename(root)
    out: List[Violation] = []
    for path in _iter_py_files(root):
        rel = os.path.relpath(path, root).replace(os.sep, "/")
        display = f"{rootname}/{rel}"
        with open(path, encoding="utf-8") as f:
            source = f.read()
        try:
            tree = ast.parse(source, filename=path)
        except SyntaxError as e:
            out.append(Violation(rule="parse-error", file=display,
                                 line=e.lineno or 0,
                                 message=f"syntax error: {e.msg}"))
            continue
        lines = source.splitlines()
        ctx = ModuleContext(rel=rel, display=display, tree=tree,
                            lines=lines, aliases=_import_aliases(tree))
        found: List[Violation] = []
        for rule in rules:
            found.extend(rule.check(ctx))
        waivers, malformed = parse_waivers(lines, display)
        out.extend(apply_waivers(found, waivers,
                                 active_rules=[r.name for r in rules]))
        out.extend(malformed)
    out.sort(key=lambda v: (v.file, v.line, v.rule))
    return out
