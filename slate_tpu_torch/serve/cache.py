"""Prepared-program cache: the software-cache tier of the serving layer.

Reference analogue: none in SLATE — the exemplar is BLASX (PAPERS.md), a
throughput-oriented L3 BLAS built as a software cache plus a scheduler over
heterogeneous executors.  The JAX package caches AOT-compiled XLA
executables here; PyTorch has no ``jit(...).lower(...).compile()`` to copy,
so an entry is the batched program *prepared* for its key on its device:

    (routine, ((shape, dtype) per operand), Options.cache_key(), donate)

— the JAX package's key exactly, dtypes under their numpy names, so keys of
the two packages compare equal.  Building an entry on a CUDA device runs the
program once on identity systems at the key's shapes, on the cache's stream:
that loads the library kernels (MAGMA/cuSOLVER/cuBLAS load lazily) and
takes their workspaces from the caching allocator's pool of that stream, so
a request that lands in a warm bucket pays neither.  That first run is timed
as ``compile_seconds``; on the CPU an entry is the program itself and building
it runs nothing.  The cache owns the keying explicitly, counts every
hit/miss/eviction in the obs registry (``slate_serve_cache_*``), and makes
"zero misses after warm-up" a checkable property, as in the JAX package.

Donation: the bit stays in the key (``donate=True`` asks that input buffers
may be reused for outputs).  It is dropped on the CPU, as the JAX package
drops it for CPU XLA, and the batched drivers restrict it to the zero-sync
fast path (no verdict, no report, no chaos), where nothing re-reads the
operands.  The prepared programs allocate their outputs either way.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import OrderedDict
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.matrix import resolve_device, torch_dtype
from ..core.types import Options


class TensorSpec(NamedTuple):
    """Shape, dtype and device of one operand — the analogue of
    ``jax.ShapeDtypeStruct`` the warm-up sweep and the routing keys use
    without allocating anything."""

    shape: Tuple[int, ...]
    dtype: Any
    device: Any = None


def dtype_name(dtype) -> str:
    """numpy name of a torch or numpy dtype (``"float32"``, ``"complex64"``)
    — the spelling the JAX package's keys and labels carry."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _counter(name: str, help: str = ""):
    from .. import obs

    return obs.counter(name, help)


def stream_ctx(stream):
    """Enter CUDA ``stream`` on this thread (no-op without one: the CPU)."""
    return torch.cuda.stream(stream) if stream is not None \
        else contextlib.nullcontext()


def _warm_run(build: Callable, args: Sequence[Any], device: torch.device,
              stream) -> None:
    """Run ``build`` once on identity systems (A[i] = I, zero right-hand
    sides) at ``args``' shapes on ``device``, in ``stream`` when given, and
    wait for it: the library kernels load and their workspaces come from the
    pool of the stream the executor serves from."""
    with stream_ctx(stream):
        a_spec, *rest = args
        a = torch.zeros(tuple(a_spec.shape), dtype=torch_dtype(a_spec.dtype),
                        device=device)
        a.diagonal(dim1=-2, dim2=-1).fill_(1)
        ops = [a] + [torch.zeros(tuple(s.shape), dtype=torch_dtype(s.dtype),
                                 device=device) for s in rest]
        build(*ops)
        torch.cuda.current_stream(device).synchronize()


class ExecutableCache:
    """LRU cache of prepared batched solve programs.

    ``get(routine, build, args, opts)`` returns a callable: on a hit, the
    stored entry; on a miss, ``build`` is prepared for the shapes/dtypes of
    ``args`` (on a CUDA device: one run on identity systems) and stored.
    An entry is the program itself: calling it runs ``build`` on the
    caller's operands, on their device, in the current stream.
    Keys fold in ``Options.cache_key()`` so two option sets that would run
    different programs never share an entry.

    ``capacity`` bounds the LRU.  An entry holds no device memory of its
    own — the workspaces its warm run took belong to the caching allocator —
    so on CUDA an eviction frees nothing and only forgets that the key was
    warmed: the key's next miss pays one more warm run, with a stream sync,
    on the thread that misses.  The bound, the LRU order and the counters
    are kept for parity with the JAX package (the default serving
    configuration warms 96 entries, under the default 256).

    ``device`` / ``stream`` name where entries are prepared when ``args``
    are :class:`TensorSpec`\\ s without a device (the warm-up sweep); the
    executor pool sets both to its executor's device and stream.  Tensor
    operands are prepared on their own device.
    """

    def __init__(self, capacity: int = 256, device=None):
        self.capacity = int(capacity)
        self.device = None if device is None else torch.device(device)
        self.stream = None
        self._lock = threading.Lock()
        self._table: "OrderedDict[tuple, Any]" = OrderedDict()
        #: owning executor's label (set by the pool); when present, every
        #: cache counter/histogram sample carries it as ``executor=`` so
        #: per-executor hit rates are readable straight from metrics.json
        self.owner: Optional[str] = None
        # residency hooks (set by ExecutorPool): which executor holds which
        # prepared key is the routing signal of the residency-aware
        # scheduler; called OUTSIDE the cache lock
        self.on_insert: Optional[Callable[[tuple], None]] = None
        self.on_evict: Optional[Callable[[tuple], None]] = None
        self.on_drop: Optional[Callable[[], None]] = None
        # plain-int mirror of the obs counters: tests and the smoke gate read
        # these without label arithmetic; the obs registry carries the same
        # events with routine/bucket labels for metrics.json
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        # per-thread record of the most recent get(): the serving queue reads
        # it to split a request's "cache" stage (lookup + possible build)
        # from its "execute" stage, and to stamp hit/miss on flight records
        self._calls = threading.local()

    # -- keying --------------------------------------------------------------
    @staticmethod
    def make_key(routine: str, args: Sequence[Any],
                 opts: Optional[Options], donate: bool) -> tuple:
        shapes = tuple((tuple(a.shape), dtype_name(a.dtype)) for a in args)
        okey = (Options.make(opts).cache_key() if not isinstance(opts, tuple)
                else opts)
        return (routine, shapes, okey, bool(donate))

    @staticmethod
    def _labels(routine: str, args: Sequence[Any]) -> Dict[str, str]:
        lead = args[0]
        bucket = "x".join(str(d) for d in lead.shape[1:]) if lead.shape else ""
        return {"routine": routine, "bucket": bucket,
                "batch": str(lead.shape[0] if lead.shape else 0),
                "dtype": dtype_name(lead.dtype)}

    def _device_of(self, args: Sequence[Any]) -> torch.device:
        dev = getattr(args[0], "device", None)
        if dev is not None:
            return torch.device(dev)
        return self.device if self.device is not None else resolve_device(None)

    # -- the cache -----------------------------------------------------------
    def get(self, routine: str, build: Callable, args: Sequence[Any],
            opts: Optional[Options] = None, donate: bool = False):
        """The prepared program for ``build`` at ``args``'s shapes.

        ``build`` must be a pure function of ``args`` (the batched cores);
        it is only prepared on a miss.  ``donate`` is dropped on the CPU
        (see the module docstring)."""
        device = self._device_of(args)
        if donate and device.type == "cpu":
            donate = False
        t_lookup = time.perf_counter()
        key = self.make_key(routine, args, opts, donate)
        labels = self._labels(routine, args)
        if self.owner is not None:
            labels["executor"] = self.owner
        with self._lock:
            ex = self._table.get(key)
            if ex is not None:
                self._table.move_to_end(key)
                self.hits += 1
                _counter("slate_serve_cache_hits_total",
                         "executable-cache hits").inc(**labels)
                self._calls.last = {
                    "hit": True,
                    "seconds": time.perf_counter() - t_lookup}
                return ex
            self.misses += 1        # counted under the lock, like hits
        # prepare outside the lock: a long first run must not serialize
        # unrelated buckets' lookups
        _counter("slate_serve_cache_misses_total",
                 "executable-cache misses (one build each)").inc(**labels)
        t0 = time.perf_counter()
        ex = build
        if device.type == "cuda":
            _warm_run(build, args, device, self.stream)
        from .. import obs

        obs.histogram("slate_serve_compile_seconds",
                      "entry build time per cache miss").observe(
                          time.perf_counter() - t0, **labels)
        evicted = []
        with self._lock:
            # a racing build of the same key: last one wins, both usable
            self._table[key] = ex
            self._table.move_to_end(key)
            while len(self._table) > self.capacity:
                evicted.append(self._table.popitem(last=False)[0])
                self.evictions += 1
                _counter("slate_serve_cache_evictions_total",
                         "executable-cache LRU evictions").inc()
            obs.gauge("slate_serve_cache_size",
                      "live entries in the cache").set(len(self._table))
        # residency hooks fire outside the lock (the pool takes its own)
        if self.on_insert is not None:
            self.on_insert(key)
        if self.on_evict is not None:
            for k in evicted:
                self.on_evict(k)
        self._calls.last = {"hit": False,
                            "seconds": time.perf_counter() - t_lookup,
                            "compile_seconds": time.perf_counter() - t0}
        return ex

    def last_lookup(self) -> Optional[Dict[str, Any]]:
        """This thread's most recent ``get()``: ``{"hit", "seconds"[,
        "compile_seconds"]}`` — the serving queue's cache-stage probe (None
        before any call on this thread)."""
        last = getattr(self._calls, "last", None)
        return dict(last) if last is not None else None

    def warmup(self, routine: str, build: Callable,
               shapes: Sequence[Tuple[Tuple[int, ...], Any]],
               opts: Optional[Options] = None, donate: bool = False,
               slots: Optional[Sequence[int]] = None) -> int:
        """Prepare entries ahead of traffic; returns how many entries are
        now warm for this call.

        ``shapes`` is a sequence of ``(shape, dtype)`` pairs, one per
        argument of ``build`` (dtype a numpy or torch dtype) — the warm-up
        API the queue calls for every (routine, shape bucket, batch bucket)
        combo it may pack, so the serving path hits 100% after warm-up by
        construction.  Entries are prepared on this cache's ``device``.

        ``slots`` is the **slot ladder** (continuous batching): a sequence
        of batch capacities.  Each entry prepares one variant with that
        capacity prepended as the leading batch axis of every shape in
        ``shapes`` (which then describe ONE element's bucket shape, no
        batch axis) — so a staged chunk of any occupancy dispatches into
        the smallest fitting slot without a fresh build, ghost slots
        filling the rest.  ``slots=None`` keeps the single-entry behavior
        (``shapes`` carry their own batch axis)."""
        ladders = [None] if slots is None else list(slots)
        for nb in ladders:
            args = [TensorSpec(tuple(s) if nb is None else (int(nb),) + tuple(s),
                               torch_dtype(d), self.device)
                    for s, d in shapes]
            self.get(routine, build, args, opts, donate=donate)
        return len(ladders)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"hits": self.hits, "misses": self.misses,
                    "evictions": self.evictions, "size": len(self._table)}

    def drop(self) -> None:
        """Forget every entry but KEEP the hit/miss counters — the chaos
        ``cache_flush`` fault uses this so the rebuilds it forces stay
        visible as misses in the very stats that diagnose it."""
        with self._lock:
            self._table.clear()
        if self.on_drop is not None:
            self.on_drop()

    def clear(self) -> None:
        with self._lock:
            self._table.clear()
            self.hits = self.misses = self.evictions = 0
        if self.on_drop is not None:
            self.on_drop()

    def holds(self, key: tuple) -> bool:
        """Whether ``key`` (an exact :meth:`make_key` tuple) is resident —
        a point-in-time read the routing layer uses without touching LRU
        order or the hit/miss counters."""
        with self._lock:
            return key in self._table

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)


#: the process-wide cache the batched drivers and the default queue share
_DEFAULT: Optional[ExecutableCache] = None
_DEFAULT_LOCK = threading.Lock()


def default_cache() -> ExecutableCache:
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None:
            _DEFAULT = ExecutableCache()
        return _DEFAULT


def reset_cache() -> None:
    """Drop the process-wide cache (test isolation; frees its entries)."""
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is not None:
            _DEFAULT.clear()
        _DEFAULT = None
