"""Committed-baseline handling for slate-lint (the JAX package's, with a
schema string of the port's own).

``analysis/baseline.json`` records pre-existing accepted findings so they
don't block CI while anything *new* fails it.  Every entry carries a
mandatory ``reason`` (the acceptance criterion: an accepted finding without
a written justification is itself a gate failure), and entries match
findings by the line-number-free fingerprint (rule, path, context,
line_text) so unrelated edits don't invalidate the file.

Matching is multiset-aware: an entry absorbs at most ``count`` occurrences
(default 1), so a second identical violation in the same function is a new
finding, not a free ride.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .findings import Finding

SCHEMA = "slate_tpu_torch.lint_baseline/v1"

#: default baseline location, next to this module
DEFAULT_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "baseline.json")


def load(path: Optional[str] = None) -> Dict[str, Any]:
    """Load the baseline document ({} shape when the file is absent)."""
    path = path or DEFAULT_PATH
    if not os.path.exists(path):
        return {"schema": SCHEMA, "entries": []}
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    if doc.get("schema") != SCHEMA:
        raise ValueError(f"{path}: schema must be {SCHEMA!r}, "
                         f"got {doc.get('schema')!r}")
    return doc


def validate(doc: Dict[str, Any]) -> List[str]:
    """Structural problems in a baseline document (empty list = valid).

    The reason requirement is enforced here: the gate fails on an entry
    whose reason is missing/empty/TODO."""
    problems: List[str] = []
    entries = doc.get("entries")
    if not isinstance(entries, list):
        return ["entries must be a list"]
    for i, e in enumerate(entries):
        where = f"entry {i} ({e.get('rule')} {e.get('path')})"
        for key in ("rule", "path", "context", "line_text"):
            if not isinstance(e.get(key), str) or not e.get(key):
                problems.append(f"{where}: missing/empty {key!r}")
        reason = e.get("reason")
        if not isinstance(reason, str) or len(reason.strip()) < 8 \
                or reason.strip().upper().startswith("TODO"):
            problems.append(f"{where}: needs a real reason "
                            "(>= 8 chars, not TODO)")
        count = e.get("count", 1)
        if not isinstance(count, int) or isinstance(count, bool) or count < 1:
            problems.append(f"{where}: count must be a positive int")
    return problems


def _key(e: Dict[str, Any]) -> Tuple[str, str, str, str]:
    return (e["rule"], e["path"], e["context"], e["line_text"])


def _entry_count(e: Dict[str, Any]) -> Optional[int]:
    """The entry's finding budget, or None when malformed (a hand-edited
    ``"count": "two"`` must surface as a validate() problem, not a
    traceback out of the --check gate)."""
    c = e.get("count", 1)
    return c if isinstance(c, int) and not isinstance(c, bool) and c >= 1 \
        else None


def _well_formed(e: Any) -> bool:
    """Entry is usable by apply(): the four fingerprint fields are
    non-empty strings and the count is sane.  Hand-edited entries failing
    this are skipped here and reported by validate() — apply() must never
    traceback on them."""
    return (isinstance(e, dict)
            and all(isinstance(e.get(k), str) and e.get(k)
                    for k in ("rule", "path", "context", "line_text"))
            and _entry_count(e) is not None)


def apply(findings: Sequence[Finding], doc: Dict[str, Any]
          ) -> Tuple[List[Finding], List[Finding], List[Dict[str, Any]]]:
    """Partition findings against the baseline.

    Returns ``(new, accepted, stale_entries)`` — findings not covered by
    the baseline, findings absorbed by it, and baseline entries that no
    longer match anything (prime candidates for deletion; reported, not
    fatal, so a fix doesn't force a lockstep baseline edit)."""
    entries = [e for e in doc.get("entries", []) if _well_formed(e)]
    totals: Dict[Tuple[str, str, str, str], int] = {}
    for e in entries:
        totals[_key(e)] = totals.get(_key(e), 0) + _entry_count(e)
    budget = dict(totals)
    new: List[Finding] = []
    accepted: List[Finding] = []
    for f in findings:
        k = f.fingerprint()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            accepted.append(f)
        else:
            new.append(f)
    # stale: allocate each fingerprint's *consumed* budget to its entries
    # in file order; an entry none of whose count was needed is stale.
    # (Per-entry, not per-fingerprint: two duplicate entries pooling to
    # count 2 with one live finding must report exactly one stale, not
    # both — one of them is still absorbing.)
    used = {k: totals[k] - budget.get(k, 0) for k in totals}
    stale: List[Dict[str, Any]] = []
    for e in entries:
        k = _key(e)
        take = min(used.get(k, 0), _entry_count(e))
        used[k] = used.get(k, 0) - take
        if take == 0:
            stale.append(e)
    return new, accepted, stale


def build(findings: Sequence[Finding],
          prev: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Baseline document covering ``findings``; reasons carry over from
    ``prev`` where fingerprints match, else are stamped TODO for a human
    (the gate refuses TODO reasons, so --update-baseline output cannot be
    committed unreviewed)."""
    reasons: Dict[Tuple[str, str, str, str], str] = {}
    for e in (prev or {}).get("entries", []):
        if _well_formed(e) and isinstance(e.get("reason"), str):
            reasons[_key(e)] = e["reason"]
    counts: Dict[Tuple[str, str, str, str], int] = {}
    meta: Dict[Tuple[str, str, str, str], Finding] = {}
    for f in findings:
        k = f.fingerprint()
        counts[k] = counts.get(k, 0) + 1
        meta.setdefault(k, f)
    entries = []
    for k in sorted(counts):
        rule, path, context, line_text = k
        e: Dict[str, Any] = {
            "rule": rule, "path": path, "context": context,
            "line_text": line_text,
            "reason": reasons.get(k, "TODO: justify or fix"),
        }
        if counts[k] > 1:
            e["count"] = counts[k]
        entries.append(e)
    return {"schema": SCHEMA, "entries": entries}


def save(doc: Dict[str, Any], path: Optional[str] = None) -> str:
    path = path or DEFAULT_PATH
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")
    return path
