"""Shared checker vocabulary: violations, waivers, diagnostics format
(counterpart of ``analysis/base.py``, with the same semantics and the
same waiver syntax, so a waiver reads the same in both packages).

The waiver contract is the load-bearing design decision.  A static rule
that cannot express exceptions gets deleted the first time it is wrong;
a rule whose exceptions are silent (skip-lists inside the checker) rots
the other way — nobody can see what was exempted or why.  Here every
exception is declared **in the source it exempts**::

    mesh = DeviceMesh(t, ranks)  # az-allow: one-placement-site — <why>

    # az-allow: one-clock — <why>
    t0 = time.monotonic()

A trailing waiver covers its own logical statement (every physical
line of a wrapped call); a standalone comment covers the statement
below it.  The reason is mandatory (a reason-less waiver is itself a
violation) and an unused waiver is a violation too, so a waiver cannot
outlive the exception it documents.  The CLI prints every applied
waiver with its reason — counted, never silent.
"""

from __future__ import annotations

import dataclasses
import io
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: ``# az-allow: <rule> — <reason>`` (en/em dash or ``-`` accepted).
_WAIVER_RE = re.compile(
    r"#\s*az-allow:\s*(?P<rule>[A-Za-z0-9_-]+)\s*(?P<rest>.*)$")
_DASH_RE = re.compile(r"^[\s—–-]+")


@dataclasses.dataclass(frozen=True)
class Violation:
    """One diagnostic: ``file:line rule message``.  ``waived`` marks a
    violation covered by an in-source waiver (kept in the report so the
    exception stays visible); only un-waived violations fail the run."""

    rule: str
    file: str
    line: int
    message: str
    waived: bool = False
    waiver_reason: str = ""


@dataclasses.dataclass
class Waiver:
    """One parsed ``az-allow`` comment and the lines it covers."""

    rule: str
    reason: str
    file: str
    line: int                     # line the comment sits on
    covers: Tuple[int, ...]       # lines it exempts
    used: int = 0


def format_violation(v: Violation) -> str:
    tag = f" [waived: {v.waiver_reason}]" if v.waived else ""
    return f"{v.file}:{v.line} {v.rule}{tag} {v.message}"


def parse_waivers(lines: Sequence[str], file: str
                  ) -> Tuple[List[Waiver], List[Violation]]:
    """Scan raw source lines for waiver comments.

    Returns ``(waivers, violations)`` where the violations are malformed
    waivers (rule present but no reason) — a waiver must say *why* or it
    is itself a finding (rule ``waiver-syntax``).

    Tokenizer-based on purpose: only REAL comment tokens count, so a
    docstring or string literal that merely *mentions* the syntax (this
    module's own docstring, docs examples, test fixtures as strings)
    never creates a stray waiver.  Both placements cover every physical
    line of one whole LOGICAL statement — the one the trailing comment
    sits on, or the next one below a standalone comment — because a
    violation may anchor to any line of a multi-line call (the call's
    first line for the call itself, a continuation line for a nested
    call)."""
    waivers: List[Waiver] = []
    violations: List[Violation] = []
    source = "\n".join(lines) + "\n"
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return waivers, violations      # unparsable → the engine reports
    _SKIP = {tokenize.NL, tokenize.COMMENT, tokenize.INDENT,
             tokenize.DEDENT, tokenize.ENCODING, tokenize.ENDMARKER}
    statements: List[Tuple[int, int]] = []   # logical-stmt line extents
    # (rule, reason, comment line, stmt_start-at-comment; 0=standalone)
    pending: List[Tuple[str, str, int, int]] = []
    stmt_start: int = 0                      # 0 = no code yet this stmt
    for tok in tokens:
        if tok.type == tokenize.NEWLINE:
            if stmt_start:
                statements.append((stmt_start, tok.start[0]))
            stmt_start = 0
            continue
        if tok.type not in _SKIP:
            if stmt_start == 0:
                stmt_start = tok.start[0]
            continue
        if tok.type != tokenize.COMMENT:
            continue
        m = _WAIVER_RE.search(tok.string)
        if not m:
            continue
        lineno = tok.start[0]
        rule = m.group("rule")
        reason = _DASH_RE.sub("", m.group("rest")).strip()
        if not reason:
            violations.append(Violation(
                rule="waiver-syntax", file=file, line=lineno,
                message=f"waiver for {rule!r} carries no reason — write "
                        f"'# az-allow: {rule} — <why this exception is "
                        f"sound>'"))
            continue
        pending.append((rule, reason, lineno, stmt_start))
    for rule, reason, lineno, start in pending:
        if start:
            # trailing (comment on any physical line of a statement):
            # cover that statement's FULL extent
            extent = next(((s, e) for s, e in statements
                           if s == start and e >= lineno),
                          (start, lineno))
        else:
            # standalone: the next logical statement below (a multi-
            # line one covered whole); none follows → next line only
            extent = next(((s, e) for s, e in statements if s > lineno),
                          (lineno + 1, lineno + 1))
        covers = (lineno,) + tuple(range(extent[0], extent[1] + 1))
        waivers.append(Waiver(rule=rule, reason=reason, file=file,
                              line=lineno, covers=covers))
    waivers.sort(key=lambda w: w.line)
    return waivers, violations


def apply_waivers(violations: Iterable[Violation],
                  waivers: Sequence[Waiver],
                  active_rules: Optional[Iterable[str]] = None
                  ) -> List[Violation]:
    """Mark violations covered by a matching waiver (same file, same
    rule, covered line) and surface unused waivers as violations
    (rule ``waiver-unused``) so dead exemptions cannot accumulate.

    ``active_rules``: the rule names that actually RAN.  A waiver for a
    rule outside the set is left alone instead of escalating to
    waiver-unused — a subset-rule run (tests pinning one rule, a future
    ``--rule`` CLI filter) must not report other rules' legitimate
    waivers as dead."""
    active = None if active_rules is None else set(active_rules)
    index: Dict[Tuple[str, str, int], Waiver] = {}
    for w in waivers:
        for ln in w.covers:
            index[(w.file, w.rule, ln)] = w

    out: List[Violation] = []
    for v in violations:
        w = index.get((v.file, v.rule, v.line))
        if w is not None:
            w.used += 1
            v = dataclasses.replace(v, waived=True, waiver_reason=w.reason)
        out.append(v)
    for w in waivers:
        if w.used == 0 and (active is None or w.rule in active):
            out.append(Violation(
                rule="waiver-unused", file=w.file, line=w.line,
                message=f"waiver for {w.rule!r} matched no violation — "
                        f"the exception it documented is gone; delete it"))
    return out
