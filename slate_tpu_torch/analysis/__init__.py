"""slate-lint: torch-aware static analysis + run-time collective auditor.

Two tiers, one gate (``python -m slate_tpu_torch.analysis --check``):

* **Tier A — AST linter** (:mod:`.rules` / :mod:`.lint`): the JAX package's
  rule IDs over the port's sources, each with its torch subject — host syncs
  inside the sync-free cores, kernel builds in loops, mutable cache-key
  defaults, process-global precision toggles, leftover debug hooks, ``out=``
  aliasing, taxonomy-swallowing ``except`` blocks, and missing
  ``@obs.instrument`` on public drivers.  Accepted pre-existing findings live
  in ``analysis/baseline.json`` (every entry with a written reason); anything
  new fails the gate.
* **Tier B — collective-schedule auditor** (:mod:`.collective_audit`): every
  rank's run-time collective log (``parallel.collectives.recording``), the
  same log ``obs.costaudit`` bills, checked for coverage and held against
  the other ranks' logs pairwise, for every routine of ``obs.scaling``'s
  registry on a pool of P ranks.

The AST tier is pure-stdlib AST work: the Tier B names below resolve lazily
(PEP 562), so importing the linter never pulls ``collective_audit`` →
``obs.costaudit``.
"""

from .findings import Finding, SEVERITIES
from .rules import RULES, Rule, rule_table
from .lint import lint_file, lint_package, lint_paths, lint_source
from . import baseline

#: Tier B re-exports, resolved on first attribute access so the AST tier's
#: imports stay stdlib-only
_TIER_B = ("CollectiveEvent", "audit_log", "audit_pass", "audit_routines",
           "extract_events", "participant_schedules", "verify_events",
           "verify_participant_schedules")

__all__ = [
    "Finding", "SEVERITIES", "RULES", "Rule", "rule_table",
    "lint_file", "lint_package", "lint_paths", "lint_source", "baseline",
] + list(_TIER_B)


def __getattr__(name):
    if name in _TIER_B:
        from . import collective_audit
        return getattr(collective_audit, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")
