"""Tier B: the collective-schedule auditor over run-time collective logs.

``obs/costaudit.py`` *counts* collectives; this module *orders* them.  The JAX
package walks one compiled SPMD module and can only rule out a divergent
schedule statically.  The port is multi-controller: each rank issues its own
collectives, and a rank whose sequence differs from its peers' hangs or
corrupts the payload.  So the port checks each rank's real sequence — the
log ``parallel.collectives.recording`` keeps — and the per-rank logs of one
run are independent sources, which is what the cross-participant check needs:

* **coverage** — every group names valid participants and no rank appears
  twice in one collective's groups (:func:`verify_events`);
* **cross-participant agreement** — for every pair of ranks, the collectives
  involving *both* come in the same order with the same op, group and
  point-to-point pairs on both sides (:func:`verify_participant_schedules`):
  a rank that skips an all-reduce its peers run, or runs two in another
  order, is named.

A run has no static call context: an event's ``channel_id`` is None, its
``branch_path`` is ``()`` and its ``while_depth`` 0.  A divergent branch
shows as two ranks' logs disagreeing, so the log catches it when it runs.
:func:`audit_routines` runs the ``obs.scaling`` registry on every rank of a
pool (``scaling.run_spec``, so both tools run a routine the same way).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from ..obs.costaudit import COLLECTIVE_OPS


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective in a rank's issue order."""

    op: str                                   #: HLO spelling
    name: str                                 #: ``<op>.<index in the log>``
    computation: str                          #: the calling function
    channel_id: Optional[int]                 #: None (no static channel)
    groups: Tuple[Tuple[int, ...], ...]       #: () = all ranks, one group
    branch_path: Tuple[Tuple[str, int], ...]  #: () (no static call context)
    while_depth: int                          #: 0 (a loop's rounds are events)
    #: kept for the JAX package's fields: a run has no static predicates
    cond_uniform: bool = False
    while_divergent: bool = False
    #: source→target pairs of a point-to-point op (None otherwise): direction
    #: matters at the rendezvous, so it participates in identity
    pairs: Optional[Tuple[Tuple[int, int], ...]] = None

    def participants(self, nproc: int) -> Tuple[int, ...]:
        if not self.groups:
            return tuple(range(nproc))
        out = sorted({d for g in self.groups for d in g})
        return tuple(out)

    def key(self) -> Tuple[str, Tuple[Tuple[int, ...], ...],
                           Optional[Tuple[Tuple[int, int], ...]]]:
        """Identity used when comparing schedules across participants: the
        rendezvous (op + groups + point-to-point direction), *not* the name
        or the calling function, which may legitimately differ."""
        return (self.op, self.groups, self.pairs)

    def describe(self) -> str:
        loc = self.computation
        if self.while_depth:
            loc += f" (while depth {self.while_depth})"
        if self.branch_path:
            loc += " (conditional branch " + "/".join(
                f"{c}#{i}" for c, i in self.branch_path) + \
                (", uniform predicate)" if self.cond_uniform else ")")
        groups = "all" if not self.groups else \
            ",".join("{" + ",".join(map(str, g)) + "}" for g in self.groups)
        pairs = "" if self.pairs is None else " pairs=" + \
            ",".join(f"{a}->{b}" for a, b in self.pairs)
        return (f"{self.op} %{self.name} channel={self.channel_id} "
                f"groups={groups}{pairs} in {loc}")


def extract_events(log, nproc: Optional[int] = None) -> List[CollectiveEvent]:
    """One rank's run-time log (``parallel.collectives.CollectiveRecord``s)
    as events in issue order.  ``nproc`` is accepted for the JAX package's
    signature; a log needs no mesh-size inference."""
    events = []
    for i, rec in enumerate(log):
        if rec.op not in COLLECTIVE_OPS:
            continue
        events.append(CollectiveEvent(
            op=rec.op, name=f"{rec.op}.{i}", computation=rec.site,
            channel_id=None, groups=tuple(tuple(g) for g in rec.groups),
            branch_path=(), while_depth=0, pairs=rec.pairs))
    return events


def participant_schedules(events: Sequence[CollectiveEvent], nproc: int
                          ) -> Dict[int, List[CollectiveEvent]]:
    """Project a schedule onto each participant: rank ``d`` sees exactly the
    collectives whose groups include it.  (The port's per-rank logs are
    already each rank's schedule; this projects a shared one, as in the JAX
    package, for fixtures.)"""
    out: Dict[int, List[CollectiveEvent]] = {d: [] for d in range(nproc)}
    for ev in events:
        for d in ev.participants(nproc):
            if d in out:
                out[d].append(ev)
    return out


# ---------------------------------------------------------------------------
# checks


def verify_events(events: Sequence[CollectiveEvent], nproc: int) -> List[str]:
    """Structural checks on a schedule (coverage, channels, control flow).
    Returns findings; empty list = consistent.  On a run-time log only the
    coverage checks can fire (no channels, no static branches)."""
    findings: List[str] = []
    chan_sites: Dict[int, List[str]] = {}
    for ev in events:
        seen: Dict[int, int] = {}
        for g in ev.groups:
            for d in g:
                seen[d] = seen.get(d, 0) + 1
                if d >= nproc or d < 0:
                    findings.append(
                        f"{ev.describe()}: participant {d} outside the "
                        f"P={nproc} mesh")
        dups = sorted(d for d, c in seen.items() if c > 1)
        if dups:
            findings.append(
                f"{ev.describe()}: device(s) {dups} appear in more than one "
                "replica group of the same collective (rendezvous deadlock)")
        if ev.channel_id is not None:
            chan_sites.setdefault(ev.channel_id, []).append(
                f"%{ev.name}@{ev.computation}")
        if ev.branch_path and not ev.cond_uniform:
            findings.append(
                f"{ev.describe()}: collective reachable only under a "
                "conditional branch whose predicate is not provably uniform "
                "— a divergent lax.cond predicate strands part of the mesh "
                "at the rendezvous")
        if ev.while_depth and ev.while_divergent:
            findings.append(
                f"{ev.describe()}: collective inside a while loop whose "
                "condition reads a per-device value (partition-id/replica-"
                "id/rng/infeed/recv) — divergent trip counts run a "
                "different number of rendezvous on different devices")
    for chan, sites in sorted(chan_sites.items()):
        uniq = sorted(set(sites))
        if len(uniq) > 1:
            findings.append(
                f"channel {chan} reused by {len(uniq)} distinct collective "
                f"instructions: {', '.join(uniq)} (interleaved channel "
                "reuse corrupts rendezvous matching)")
    return findings


def verify_participant_schedules(
        schedules: Dict[int, List[CollectiveEvent]],
        nproc: Optional[int] = None) -> List[str]:
    """Cross-participant agreement: for every rank pair (p, q), the
    subsequence of collectives involving *both* must be identical on both
    sides — same rendezvous, same order.  A rank missing an all-reduce the
    rest of its group runs surfaces here, named with the rank that blocks."""
    nproc = nproc if nproc is not None else len(schedules)
    findings: List[str] = []
    devs = sorted(schedules)
    for i, p in enumerate(devs):
        for q in devs[i + 1:]:
            jp = [ev for ev in schedules[p]
                  if q in ev.participants(nproc)]
            jq = [ev for ev in schedules[q]
                  if p in ev.participants(nproc)]
            kp = [ev.key() for ev in jp]
            kq = [ev.key() for ev in jq]
            if kp == kq:
                continue
            # name the first divergence precisely
            k = 0
            while k < min(len(kp), len(kq)) and kp[k] == kq[k]:
                k += 1
            if k < len(kp) and k < len(kq):
                findings.append(
                    f"participants {p} and {q} disagree at joint collective "
                    f"#{k}: device {p} expects {jp[k].describe()} but device "
                    f"{q} expects {jq[k].describe()}")
            elif k < len(kp):
                findings.append(
                    f"participant {q} is missing joint collective #{k} that "
                    f"device {p} executes: {jp[k].describe()} — device {p} "
                    "blocks at a rendezvous the peer never reaches")
            else:
                findings.append(
                    f"participant {p} is missing joint collective #{k} that "
                    f"device {q} executes: {jq[k].describe()} — device {q} "
                    "blocks at a rendezvous the peer never reaches")
    return findings


def audit_log(logs, nproc: int) -> Dict[str, Any]:
    """Audit one run: ``logs`` maps each rank to its run-time log (a list in
    rank order works too).  Every rank's schedule gets the structural checks,
    and the ranks' schedules are held against each other pairwise — they
    come from independent processes, so the pairwise check is the one that
    can fail.  Takes the place of the JAX package's ``audit_hlo``."""
    if not isinstance(logs, dict):
        logs = dict(enumerate(logs))
    schedules = {r: extract_events(log) for r, log in logs.items()}
    findings: List[str] = []
    for r in sorted(schedules):
        findings += [f"rank {r}: {f}" for f in verify_events(schedules[r], nproc)]
    findings += verify_participant_schedules(schedules, nproc)
    return {"collective_sites": max((len(s) for s in schedules.values()), default=0),
            "uniform_cond_sites": 0,
            "schedule": [ev.describe() for ev in schedules.get(min(schedules, default=0), [])],
            "findings": findings}


def audit_pass(per_rank, nproc: int) -> List[Dict[str, Any]]:
    """The audit rows of one pass: ``per_rank`` is what
    ``scaling.rank_passes`` returns for a world of ``nproc`` ranks (each
    rank's list of audit entries), and each spec's row is :func:`audit_log`
    over every rank's log, or the spec's ``skipped`` / ``error``."""
    rows: List[Dict[str, Any]] = []
    for k, entry in enumerate(per_rank[0]):
        row: Dict[str, Any] = {"routine": entry["row"]["routine"],
                               "P": nproc, "module": entry["row"]["module"]}
        problem = {key: entry["row"][key] for key in ("skipped", "error")
                   if key in entry["row"]}
        if problem:
            row.update(problem)
        else:
            row.update(audit_log([ranks[k]["log"] for ranks in per_rank], nproc))
        rows.append(row)
    return rows


def audit_routines(pset: Sequence[int] = (2, 4, 8),
                   names: Optional[Sequence[str]] = None,
                   progress=None, device=None, pool=None) -> List[Dict[str, Any]]:
    """Run the ordering audit over the ``obs.scaling`` registry: every spec
    once on every rank of a world of each requested size (``device`` cuda
    unless asked: P = 1 in this process, or a launcher's ranks; with
    ``device="cpu"`` a pool of gloo ranks; see ``scaling.rank_passes``), then
    :func:`audit_pass` over the ranks' logs."""
    from ..obs import scaling

    rows: List[Dict[str, Any]] = []
    wanted = set(names) if names else None
    if wanted is not None:
        unknown = sorted(wanted - {s.name for s in scaling.specs()})
        if unknown:
            # a typo must not read as "audited clean, 0 findings"
            raise ValueError(
                f"unknown routine name(s): {', '.join(unknown)} "
                f"(see obs.scaling.spec_names())")
    for nproc in pset:
        for row in audit_pass(scaling.rank_passes(nproc, names, device, pool), nproc):
            rows.append(row)
            if progress is not None:
                progress(row)
    return rows


def summarize(rows: Iterable[Dict[str, Any]]) -> Tuple[int, int, List[str]]:
    """(audited, total_findings, flattened finding lines) over audit rows."""
    audited = 0
    lines: List[str] = []
    for row in rows:
        if row.get("error") or row.get("skipped"):
            continue
        audited += 1
        for f in row.get("findings", ()):
            lines.append(f"P={row['P']} {row['routine']}: {f}")
    return audited, len(lines), lines
