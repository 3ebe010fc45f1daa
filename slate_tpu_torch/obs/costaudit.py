"""Run-time cost audit: collective volume and flops / bytes of one counted run.

The JAX package audits a compiled XLA program: ``cost_analysis()`` gives its
flops and bytes, and the HLO text lists every collective site once.  The port
compiles nothing ahead of time, so it counts a *run*: :func:`counted` turns on

* the collective log of ``parallel.collectives`` (every collective this rank
  issues, with its output's dtype, shape and bytes),
* ``torch.utils.flop_counter.FlopCounterMode``, which counts only the
  matmul class: LAPACK flop formulas are registered here for the
  factorizations and solves (:data:`LAPACK_FLOPS`), and one flop an element
  for the arithmetic elementwise ops and reductions (:data:`ELEMENTWISE_FLOPS`,
  as XLA's cost analysis counts them), and
* a dispatch mode that sums the operand and result bytes of every aten op
  (views and allocations excepted): ``bytes_accessed``.

These are **run-time counts per rank**, the reverse of the JAX package's
static-site caveat: a collective inside a loop counts once per iteration, and
a data-dependent exchange (LU's pivot rows) counts what this seed's data moved.
So a row is exact for its inputs and seed, and deterministic for them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch

#: collective ops audited (HLO spellings, the JAX package's)
COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute", "collective-broadcast")


def collective_volume(log) -> Dict[str, Any]:
    """The collective bill of one rank's run-time log (a list of
    ``parallel.collectives.CollectiveRecord``).

    Returns ``{"total_bytes": int, "total_count": int,
    "ops": {op: {"count": n, "bytes": b}}}`` — bytes are each collective's
    output on this rank, the quantity the JAX package bills per site."""
    ops: Dict[str, Dict[str, int]] = {}
    for rec in log:
        if rec.op not in COLLECTIVE_OPS:
            continue
        entry = ops.setdefault(rec.op, {"count": 0, "bytes": 0})
        entry["count"] += 1
        entry["bytes"] += int(rec.bytes)
    return {"total_bytes": sum(o["bytes"] for o in ops.values()),
            "total_count": sum(o["count"] for o in ops.values()),
            "ops": ops}


# ---------------------------------------------------------------------------
# flop formulas for the LAPACK-class ops FlopCounterMode leaves at 0
# (real-arithmetic counts of LAPACK Working Note 41; batch dims multiply)


def _batch(shape) -> int:
    b = 1
    for d in shape[:-2]:
        b *= d
    return b


def _chol(a_shape, *args, **kwargs) -> int:
    n = a_shape[-1]
    return _batch(a_shape) * n ** 3 // 3


def _solve_tri(a_shape, b_shape, *args, left=True, **kwargs) -> int:
    m, k = b_shape[-2:]
    return _batch(b_shape) * (m * m * k if left else m * k * k)


def _triangular_solve(b_shape, a_shape, *args, **kwargs) -> int:
    m, k = b_shape[-2:]
    return _batch(b_shape) * m * m * k


def _lu(m: int, n: int) -> int:
    return m * n * n - n ** 3 // 3 if m >= n else n * m * m - m ** 3 // 3


def _lu_factor(a_shape, *args, **kwargs) -> int:
    return _batch(a_shape) * _lu(*a_shape[-2:])


def _lu_solve(lu_shape, piv_shape, b_shape, *args, **kwargs) -> int:
    n, k = lu_shape[-1], b_shape[-1]
    return _batch(b_shape) * 2 * n * n * k


def _qr(m: int, n: int) -> int:
    return 2 * m * n * n - 2 * n ** 3 // 3 if m >= n else 2 * n * m * m - 2 * m ** 3 // 3


def _geqrf(a_shape, *args, **kwargs) -> int:
    return _batch(a_shape) * _qr(*a_shape[-2:])


def _orgqr(a_shape, tau_shape, *args, **kwargs) -> int:
    m, n = a_shape[-2:]
    k = tau_shape[-1]
    return _batch(a_shape) * (4 * m * n * k - 2 * (m + n) * k * k + 4 * k ** 3 // 3)


def _ormqr(a_shape, tau_shape, c_shape, left=True, *args, **kwargs) -> int:
    m, n = c_shape[-2:]
    k = tau_shape[-1]
    return _batch(c_shape) * (4 * m * n * k - 2 * (n if left else m) * k * k)


def _linalg_qr(a_shape, mode="reduced", *args, **kwargs) -> int:
    m, n = a_shape[-2:]
    k = min(m, n)
    q = 0 if mode == "r" else 4 * m * k * k - 2 * (m + k) * k * k + 4 * k ** 3 // 3
    return _batch(a_shape) * (_qr(m, n) + q)


def _vectors(out_shape, k: int) -> bool:
    """Whether output ``k`` (the vectors) was computed (not an empty tensor;
    PyTorch computes them under a dispatch mode even for eigvalsh/svdvals)."""
    return bool(out_shape) and len(out_shape) > k and _numel(out_shape[k]) > 0


def _eigh(a_shape, *args, out_shape=None, **kwargs) -> int:
    n = a_shape[-1]
    vecs = 2 * n ** 3 if _vectors(out_shape, 1) else 0
    return _batch(a_shape) * (4 * n ** 3 // 3 + vecs)


def _svd(a_shape, *args, out_shape=None, **kwargs) -> int:
    m, n = a_shape[-2:]
    m, n = max(m, n), min(m, n)
    vals = 4 * m * n * n - 4 * n ** 3 // 3
    vecs = 4 * m * n * n + 8 * n ** 3 if _vectors(out_shape, 0) else 0
    return _batch(a_shape) * (vals + vecs)


def _solve_ex(a_shape, b_shape, *args, **kwargs) -> int:
    n = a_shape[-1]
    k = b_shape[-1] if len(b_shape) == len(a_shape) else 1
    return _batch(a_shape) * (_lu(n, n) + 2 * n * n * k)


def _cholesky_solve(b_shape, l_shape, *args, **kwargs) -> int:
    n, k = b_shape[-2:]
    return _batch(b_shape) * 2 * n * n * k


def _inv_ex(a_shape, *args, **kwargs) -> int:
    return _batch(a_shape) * 2 * a_shape[-1] ** 3


def _mv(a_shape, x_shape, *args, **kwargs) -> int:
    return 2 * a_shape[-2] * a_shape[-1]


def _addmv(c_shape, a_shape, x_shape, *args, **kwargs) -> int:
    return 2 * a_shape[-2] * a_shape[-1]


def _dot(x_shape, y_shape, *args, **kwargs) -> int:
    return 2 * x_shape[-1]


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= d
    return n


def _pointwise(*args, out_shape=None, **kwargs) -> int:
    shape = out_shape[0] if out_shape and isinstance(out_shape[0], (tuple, list)) \
        else out_shape
    return _numel(shape or ())


def _pointwise2(*args, out_shape=None, **kwargs) -> int:
    return 2 * _pointwise(out_shape=out_shape)


def _reduce(a_shape, *args, **kwargs) -> int:
    return _numel(a_shape)


def _reduce2(a_shape, *args, **kwargs) -> int:
    return 2 * _numel(a_shape)


#: the arithmetic elementwise ops and reductions, one flop an element (two for
#: the fused ones and the 2-norm), as XLA's cost analysis counts them
ELEMENTWISE_FLOPS = {
    **{op: _pointwise for op in (
        "add", "add_", "sub", "sub_", "mul", "mul_", "div", "div_", "abs", "abs_",
        "neg", "neg_", "sqrt", "sqrt_", "rsqrt", "reciprocal", "maximum", "minimum",
        "clamp", "clamp_", "clamp_min", "clamp_max", "sign", "sgn", "copysign",
        "hypot", "pow", "rsub")},
    **{op: _pointwise2 for op in ("addcmul", "addcmul_", "addcdiv", "addcdiv_")},
    **{op: _reduce for op in ("sum", "amax", "amin", "max", "min", "mean",
                              "prod", "cumsum")},
    "linalg_vector_norm": _reduce2,
    "mv": _mv, "addmv": _addmv, "dot": _dot, "vdot": _dot,
}

#: aten op name -> formula over input shapes (``register_flop_formula``)
LAPACK_FLOPS = {
    "linalg_cholesky_ex": _chol, "cholesky": _chol,
    "linalg_solve_triangular": _solve_tri, "triangular_solve": _triangular_solve,
    "linalg_lu_factor_ex": _lu_factor, "linalg_lu": _lu_factor,
    "linalg_lu_solve": _lu_solve,
    "geqrf": _geqrf, "linalg_householder_product": _orgqr, "orgqr": _orgqr,
    "ormqr": _ormqr, "linalg_qr": _linalg_qr,
    "_linalg_eigh": _eigh, "_linalg_svd": _svd,
    "_linalg_solve_ex": _solve_ex, "cholesky_solve": _cholesky_solve,
    "linalg_inv_ex": _inv_ex,
}

_REGISTERED = False


def register_lapack_flops() -> None:
    """Register :data:`ELEMENTWISE_FLOPS` and :data:`LAPACK_FLOPS` with
    FlopCounterMode's process-wide registry (once; an op that already has a
    formula keeps it)."""
    global _REGISTERED
    if _REGISTERED:
        return
    from torch.utils.flop_counter import flop_registry, register_flop_formula

    for name, formula in {**ELEMENTWISE_FLOPS, **LAPACK_FLOPS}.items():
        packet = getattr(torch.ops.aten, name, None)
        if packet is not None and packet not in flop_registry:
            register_flop_formula(packet)(formula)
    _REGISTERED = True


# ---------------------------------------------------------------------------
# the counted run


@dataclasses.dataclass
class Run:
    """One counted run on this rank: the collective log and the counts."""

    log: List[Any] = dataclasses.field(default_factory=list)
    flops: float = 0.0
    bytes_accessed: float = 0.0
    flops_by_op: Dict[str, int] = dataclasses.field(default_factory=dict)
    ops: int = 0                     #: aten ops dispatched on plain tensors


_NO_TRAFFIC = ("empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "_local_scalar_dense", "lift_fresh", "detach")


def _tensor_bytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_tensor_bytes(v) for v in x)
    return 0


def _byte_counter(run: Run):
    """The dispatch mode that sums each op's operand and result bytes and
    hands every op to the collective log (DTensor's functional collectives)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    from ..parallel.collectives import note_functional

    class _Bytes(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented          # let DTensor lower to local ops
            out = func(*args, **kwargs)
            run.ops += 1
            note_functional(func, args, kwargs, out)
            packet = getattr(func, "_overloadpacket", None)
            if not getattr(func, "is_view", False) and packet is not None \
                    and packet.__name__ not in _NO_TRAFFIC:
                run.bytes_accessed += _tensor_bytes(args) + _tensor_bytes(out) + \
                    _tensor_bytes(list(kwargs.values()))
            return out

    return _Bytes()


@contextlib.contextmanager
def counted(run: Optional[Run] = None):
    """Count the block: its collective log, flops and bytes; yields the
    :class:`Run` (filled in when the block ends)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..parallel.collectives import recording

    register_lapack_flops()
    run = Run() if run is None else run
    fc = FlopCounterMode(display=False)
    with recording(run.log, watch=False), fc, _byte_counter(run):
        yield run
    run.flops = float(fc.get_total_flops())
    run.flops_by_op = {str(k): int(v) for k, v in
                       fc.get_flop_counts().get("Global", {}).items()}


def harvest(run) -> Dict[str, Any]:
    """Audit one counted run (:func:`counted`): this rank's flops / bytes and
    its collectives.  Returns::

        {"flops": float, "bytes_accessed": float,
         "collective_bytes": int, "collective_count": int,
         "collectives": {op: {count, bytes}},
         "comm_compute_ratio": float | None}   # collective bytes per flop
    """
    vol = collective_volume(run.log)
    flops = float(run.flops)
    return {
        "flops": flops,
        "bytes_accessed": float(run.bytes_accessed),
        "collective_bytes": int(vol["total_bytes"]),
        "collective_count": int(vol["total_count"]),
        "collectives": vol["ops"],
        "comm_compute_ratio": (vol["total_bytes"] / flops) if flops > 0 else None,
    }


def harvest_many(runs) -> Dict[str, Any]:
    """Sum :func:`harvest` across several counted runs (a driver the caller
    composes from several calls)."""
    agg: Dict[str, Any] = {"flops": 0.0, "bytes_accessed": 0.0,
                           "collective_bytes": 0, "collective_count": 0,
                           "collectives": {}, "programs": 0}
    for run in runs:
        h = harvest(run)
        agg["flops"] += h["flops"]
        agg["bytes_accessed"] += h["bytes_accessed"]
        agg["collective_bytes"] += h["collective_bytes"]
        agg["collective_count"] += h["collective_count"]
        agg["programs"] += 1
        for op, e in h["collectives"].items():
            dst = agg["collectives"].setdefault(op, {"count": 0, "bytes": 0})
            dst["count"] += e["count"]
            dst["bytes"] += e["bytes"]
    agg["comm_compute_ratio"] = (agg["collective_bytes"] / agg["flops"]
                                 if agg["flops"] > 0 else None)
    return agg
