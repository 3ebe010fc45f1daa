"""Many small solves through the serving tier: an open loop at a fixed rate.

The configuration sets up the deployment: one ``ServeQueue`` with its
``BucketPolicy``, executors and admission bounds, serving in the stated
precision.  The traffic file sets the mix and the rate
(:class:`slatebench.gen.Requests`).

Set-up makes every request's operands, builds the queue, prepares every
(routine, bucket, batch rung) the mix can need (``ServeQueue.warmup``), and
sends a warm burst of ``max_batch`` requests of every shape through the
queue.  In the window one client thread submits each request when it is due,
sleeping in between; one collector thread waits on the oldest request still
out and, whenever it wakes, takes every other one that is done.  A request's
latency runs from when it was due to when the collector holds its result.
The window closes ``--seconds`` after it opened, when the last request is
due; the requests done by then are the window's completions.  The collector
then waits for every request, a minute past the close at most.

Once every request is in and the queue is closed, a sample of requests drawn
from the seed (with every shape of the mix in it) is solved again by the
plain reference in f64, and the widest relative gap of the served x is held
to the traffic's limit; no request may fail, time out or report info ≠ 0.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from slatebench import flops, gen
from slatebench.devtrace import DeviceTrace, Spans
from slatebench.reference import dense

#: requests past the oldest one out that the collector looks at on each wake
LOOKAHEAD = 256
#: how long past the window's close a request may still come in
GRACE_S = 60.0
COUNTERS = ("slate_serve_pad_seconds", "slate_serve_batch_occupancy")


def _hist_totals(name: str):
    from slate_tpu_torch import obs

    h = obs.REGISTRY.get(name)
    states = list(h.series().values()) if h is not None else []
    return sum(s["sum"] for s in states), sum(s["count"] for s in states)


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def make_queue(cfg, device):
    from slate_tpu_torch import serve

    policy = serve.BucketPolicy(**{k: tuple(v) if isinstance(v, list) else v
                                   for k, v in cfg["policy"].items()})
    admission = serve.AdmissionPolicy(**cfg.get("admission", {}))
    return serve.ServeQueue(policy=policy, admission=admission,
                            executors=int(cfg["executors"]),
                            cache=serve.ExecutableCache(), device=device)


def _warm(q, reqs, dtype) -> None:
    """Prepare every program the mix needs, then push ``max_batch`` requests
    of every shape through the queue (the packer, the copies, the resolve)."""
    shapes = sorted({reqs.shape(k) for k in range(len(reqs.kind))})
    q.warmup(shapes, dtype=dtype)
    tickets = []
    for k in reqs.first_of_each():
        routine = reqs.shape(k)[0]
        a, b = reqs.operands(k)
        tickets += [q.submit(routine, a, b) for _ in range(q.policy.max_batch)]
    for t in tickets:
        t.result(timeout=300.0)


class Collector(threading.Thread):
    """Waits on the oldest request still out; on every wake takes each
    request of the next :data:`LOOKAHEAD` that is done.  A request taken
    leaves its completion time, info and queue wait, and its answer only if
    it is in the check's sample: the ticket itself is dropped, as a client
    drops a request it has answered, so the heap the program's threads share
    does not grow with the window."""

    def __init__(self, count: int, keep, deadline: float):
        super().__init__(name="slatebench-collector", daemon=True)
        self.tickets = []
        self.cond = threading.Condition()
        self.done_at = [None] * count
        self.info = [None] * count
        self.queue_wait = [None] * count
        self.errors = {}
        self.kept = {}
        self.keep = keep
        self.deadline = deadline
        self.count = count

    def add(self, ticket) -> None:
        with self.cond:
            self.tickets.append(ticket)
            self.cond.notify()

    def _take(self, k: int, now: float) -> None:
        ticket = self.tickets[k]
        try:
            x, info = ticket.result(timeout=0)
        except Exception as e:                        # a failed request
            self.errors[k] = f"{type(e).__name__}: {e}"
        else:
            self.info[k] = int(info)
            if k in self.keep:
                self.kept[k] = x
        self.queue_wait[k] = ticket.stages.get("queue_wait")
        self.done_at[k] = now
        self.tickets[k] = None

    def done_now(self):
        """The requests done at this moment (taken, or done and not yet)."""
        return [k for k, t in enumerate(self.tickets)
                if t is None or t.done()]

    def run(self) -> None:
        done_at, tickets = self.done_at, self.tickets
        for i in range(self.count):
            with self.cond:
                while len(tickets) <= i:
                    self.cond.wait()
            if done_at[i] is not None:
                continue
            if not _wait(tickets[i], self.deadline - time.perf_counter()):
                return                                # the rest never came
            now = time.perf_counter()
            self._take(i, now)
            for j in range(i + 1, min(i + LOOKAHEAD, len(tickets))):
                if done_at[j] is None and tickets[j].done():
                    self._take(j, now)


def _wait(ticket, timeout: float) -> bool:
    try:
        ticket.result(timeout=max(timeout, 0.0))
    except TimeoutError:
        return False
    except Exception:
        pass
    return True


def _open_loop(q, reqs, t0, t_close, keep, trace, spans):
    """Submit each request when it is due while a collector takes them.
    Returns the collector, the requests done when the window closed, and how
    late the client ran."""
    coll = Collector(len(reqs), keep, t_close + GRACE_S)
    coll.start()
    due = t0 + reqs.due
    late = 0.0
    for k in range(len(reqs)):
        pause = due[k] - time.perf_counter()
        if pause > 0:
            time.sleep(pause)
        ts = time.perf_counter()
        a, b = reqs.operands(k)
        coll.add(q.submit(reqs.shape(k)[0], a, b))
        spans.add(ts, time.perf_counter(), "submit")
        late = max(late, ts - due[k])
    pause = t_close - time.perf_counter()
    if pause > 0:
        time.sleep(pause)
    if trace is not None:
        trace.stop()
    in_window = coll.done_now()
    coll.join(GRACE_S + (t_close - t0))
    return coll, in_window, late


def control_options():
    """The control: the sampled requests answered again from operands
    rounded to TF32, next to the program's answers."""
    return {"control": True}


def run(r, device, control: bool = False) -> None:
    cfg = r.cell.config
    traffic = r.cell.traffic
    dtype = getattr(torch, cfg["dtype"])
    r.dtype = cfg["dtype"]
    reqs = gen.Requests(traffic, r.seconds, r.seed, dtype, device)
    r.mark("inputs_made")
    count = len(reqs)
    firsts = {}
    for k in range(count):
        firsts.setdefault(reqs.kind[k % len(reqs.kind)], k)
    keep = set(gen.sample(range(count), int(traffic["check_sample"]), r.seed,
                          must=firsts.values()))
    q = make_queue(cfg, device)
    r.mark("program_imported")
    try:
        _warm(q, reqs, dtype)
        r.mark("warmed")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        before = {n: _hist_totals(n) for n in COUNTERS}
        spans = Spans()
        trace = DeviceTrace(device) if r.trace and device.type == "cuda" else None
        if trace is not None:
            trace.start()
        t0 = time.perf_counter()
        r.setup_s = t0 - r.t_process
        coll, in_window, r.submit_late_s = _open_loop(
            q, reqs, t0, t0 + r.seconds, keep, trace, spans)
        after = {n: _hist_totals(n) for n in COUNTERS}
    finally:
        q.close()
    if device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(device)

    done = np.array([np.nan if v is None else v for v in coll.done_at])
    lat = done - (t0 + reqs.due)
    r.latency_s = np.where(np.isnan(lat), np.inf, lat)
    r.completed_in_window = len(in_window)
    r.window_s = r.seconds
    for k in in_window:
        routine, m, n, nrhs = reqs.shape(k)
        r.flops += flops.solve_flops(routine, m, n, nrhs)
        r.bytes += flops.solve_bytes(m, n, nrhs, torch.finfo(dtype).bits // 8)
    r.stages["queue_wait"] = [v for v in coll.queue_wait if v is not None]
    r.counters = {n: (after[n][0] - before[n][0], after[n][1] - before[n][1])
                  for n in COUNTERS}
    if trace is not None:
        r.device_trace = trace.summary(spans, "client_idle")

    missing = int(np.isnan(done).sum())
    info_bad = sum(1 for v in coll.info if v not in (None, 0))
    r.attempted = count
    r.failed = missing + len(coll.errors) + info_bad
    gaps, control_gaps = [], []
    for k in sorted(coll.kept):
        routine = reqs.shape(k)[0]
        a, b = (_host(v) for v in reqs.operands(k))
        ref = dense.solve_f64(routine, a, b)
        gaps.append(dense.rel_gap(_host(coll.kept[k]), ref))
        if control:
            control_gaps.append(dense.rel_gap(dense.solve_tf32(routine, a, b),
                                              ref))
    r.check("gap_max", max(gaps, default=float("inf")),
            float(traffic["gap_limit"]))
    r.check("failed", r.failed, 0)
    r.check("unchecked", len(keep) - len(gaps), 0)
    if control:
        r.control_gap = max(control_gaps) if control_gaps else float("nan")
