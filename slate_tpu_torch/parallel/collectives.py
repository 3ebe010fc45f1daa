"""Grid-dim collective primitives for the shard-local bodies.

Reference analogue (SURVEY.md §5.8): SLATE's tile collectives — ``listBcast``
(BaseMatrix.hh:1999-2100), ``listReduce`` (BaseMatrix.hh:2219-2258), the pivot
``MPI_Bcast`` (getrf.cc:113-119) and the lookahead panel sends.

Each helper runs over one grid dim (``"p"`` or ``"q"``) or both flattened
(``FLAT``, p-major: rank i*q + j), on the process groups of the grid's
``DeviceMesh``.  Every rank of the group must call it with a tensor of the
same shape.  All traffic goes through the module-level primitives
(``_all_reduce``, ``_all_gather``, ``_reduce_scatter``, and ``_send_recv`` /
``_exchange`` for point to point).
NCCL has no complex type, so complex tensors travel as their real view.

=====================  ==============================================
reference pattern      primitive
=====================  ==============================================
listBcast (root tile)  ``axis_bcast`` (sum of a masked contribution)
panel gather           ``axis_allgather``
listReduce             ``axis_allreduce`` / ``axis_reduce_scatter``
lookahead panel sends  ``ring_shift`` (point to point)
chase boundary sends   ``neighbor_exchange`` (point to point, not cyclic)
=====================  ==============================================

**The collective log.** Inside :func:`recording`, every primitive appends one
:class:`CollectiveRecord` to the log: the logical op in the JAX package's HLO
spelling (``obs.costaudit.COLLECTIVE_OPS``), the global ranks of the group,
the source→target pairs of a point-to-point op, and the dtype, shape and bytes
of the collective's output on this rank.  A logical op is recorded, never the
backend's substitute: gloo's reduce-scatter runs an all-reduce and is logged
as a ``reduce-scatter`` of the kept slice (``wire`` names what ran).  A
point-to-point op is logged by the function that runs it (``ring_shift``,
``neighbor_exchange``, the all-to-alls of ``distribute``), which alone knows
every member's pairs, so each rank logs the same rendezvous.
Collectives that DTensor issues itself (``full_tensor``, ``redistribute``,
arithmetic on DTensors) bypass the primitives; the log catches them with a
dispatch mode that watches the functional collectives.  The recorder reads
metadata only (no tensor values, no host sync) and is off outside the context.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import COL_AXIS, FLAT, ROW_AXIS

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


@dataclasses.dataclass(frozen=True)
class CollectiveRecord:
    """One collective as this rank issued it."""

    op: str                                #: HLO spelling (``all-reduce`` ...)
    groups: Tuple[Tuple[int, ...], ...]    #: global ranks of this rank's group
    pairs: Optional[Tuple[Tuple[int, int], ...]]   #: point to point only
    dtype: str
    shape: Tuple[int, ...]                 #: this rank's output
    bytes: int                             #: output bytes (received, for p2p)
    wire: str                              #: the c10d / functional op that ran
    site: str                              #: the calling function


_LOG: Optional[list] = None


def _site() -> str:
    """``module.function`` of the innermost caller in the package outside
    this module (torch's DTensor frames are skipped)."""
    f = sys._getframe(1)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod.startswith("slate_tpu_torch") and mod != __name__:
            return f"{mod.rsplit('.', 1)[-1]}.{f.f_code.co_qualname}"
        f = f.f_back
    return "?"


def _record(op: str, group, out, wire: str, pairs=None, members=None,
            nbytes: Optional[int] = None, shape=None) -> None:
    if _LOG is None:
        return
    if members is None:
        members = (dist.get_process_group_ranks(group) if group is not None
                   else range(dist.get_world_size()))
    _LOG.append(CollectiveRecord(
        op=op, groups=(tuple(sorted(int(r) for r in members)),),
        pairs=None if pairs is None else tuple(sorted(pairs)),
        dtype=str(out.dtype).replace("torch.", ""),
        shape=tuple(out.shape) if shape is None else tuple(shape),
        bytes=out.numel() * out.element_size() if nbytes is None else int(nbytes),
        wire=wire, site=_site()))


_FUNCOL_OPS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
               "shard_dim_alltoall": "all-to-all"}


def note_functional(func, args, kwargs, out) -> None:
    """Log ``func`` if it is a functional collective (what DTensor lowers its
    communication to); called by a dispatch mode on every op it sees."""
    ns = getattr(getattr(func, "_overloadpacket", None), "_qualified_op_name", "")
    lib, _, base = ns.partition("::")
    if _LOG is None or base not in _FUNCOL_OPS or \
            lib not in ("_c10d_functional", "c10d_functional", "_dtensor"):
        return
    from torch.distributed.distributed_c10d import _resolve_process_group

    gname = args[-1] if isinstance(args[-1], str) else kwargs.get("group_name")
    group = _resolve_process_group(gname)
    for t in (out if isinstance(out, (list, tuple)) else [out]):
        _record(_FUNCOL_OPS[base], group, t, wire=base)


def _funcol_watch():
    """A dispatch mode that logs the functional collectives DTensor issues
    (its ops on DTensors are let through first, so they lower to these)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            out = func(*args, **kwargs)
            note_functional(func, args, kwargs, out)
            return out

    return _Watch()


@contextlib.contextmanager
def recording(log: Optional[list] = None, watch: bool = True):
    """Log every collective this process issues inside the block; yields the
    list of :class:`CollectiveRecord` (``log``, or a new one).  ``watch=False``
    leaves DTensor's own collectives to a dispatch mode of the caller's,
    which must pass each op to :func:`note_functional`."""
    global _LOG
    prev, _LOG = _LOG, ([] if log is None else log)
    try:
        with _funcol_watch() if watch else contextlib.nullcontext():
            yield _LOG
    finally:
        _LOG = prev


def is_recording() -> bool:
    return _LOG is not None


def _mesh(grid):
    """The DeviceMesh of a ProcessGrid (a DeviceMesh passes through)."""
    from torch.distributed.device_mesh import DeviceMesh

    return grid if isinstance(grid, DeviceMesh) else grid.mesh


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The contiguous real tensor a collective moves (complex as its real view)."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=group)
    _record("all-reduce", group, t, wire="allreduce_")
    return t


def _all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    size = dist.get_world_size(group)
    out = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(out, t, group=group)
    _record("all-gather", group, t, wire="allgather_", nbytes=size * t.numel()
            * t.element_size(), shape=(size,) + tuple(t.shape))
    return out


def _reduce_scatter(t: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group, each member keeping its 1/size slice of dim 0."""
    size = dist.get_world_size(group)
    if dist.get_backend(group) == "nccl":
        out = t.new_empty((t.shape[0] // size,) + tuple(t.shape[1:]))
        dist.reduce_scatter_tensor(out, t, group=group)
        _record("reduce-scatter", group, out, wire="_reduce_scatter_base_")
        return out
    # gloo has no reduce_scatter: reduce, then keep the own slice (logged as
    # the reduce-scatter it stands for, with the slice as its output)
    dist.all_reduce(t, group=group)
    me = dist.get_group_rank(group, dist.get_rank())
    out = t.chunk(size, dim=0)[me].clone()
    _record("reduce-scatter", group, out, wire="allreduce_")
    return out


def _p2p_record(op: str, members, pairs, sends, recvs) -> None:
    """Log the point-to-point op the caller has just run: its logical op, its
    participants (global ranks), every member's source→target pairs (a
    permute; None for an all-to-all) and what this rank received.  Callers
    build ``members`` and ``pairs`` only while recording (:func:`is_recording`)."""
    like = recvs[0][0] if recvs else (sends[0][0] if sends else torch.empty(0))
    got = sum(t.numel() * t.element_size() for t, _ in recvs)
    shape = tuple(recvs[0][0].shape) if len(recvs) == 1 else \
        (sum(t.numel() for t, _ in recvs),)
    _record(op, None, like, wire="p2p", pairs=pairs, members=members, nbytes=got,
            shape=shape)


def _send_recv(send: torch.Tensor, dst: int, recv: torch.Tensor, src: int,
               group) -> torch.Tensor:
    ops = [dist.P2POp(dist.isend, send, dst, group),
           dist.P2POp(dist.irecv, recv, src, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv


def _exchange(sends, recvs) -> None:
    """Point-to-point exchange on the world group: ``sends`` and ``recvs`` are
    lists of (tensor, global rank) pairs (an all-to-all of unequal blocks)."""
    ops = ([dist.P2POp(dist.isend, t, r) for t, r in sends]
           + [dist.P2POp(dist.irecv, t, r) for t, r in recvs])
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()


def _dims(axis):
    return (ROW_AXIS, COL_AXIS) if axis == FLAT or axis == list(FLAT) else (axis,)


def axis_size(grid, axis) -> int:
    mesh = _mesh(grid)
    size = 1
    for d in _dims(axis):
        size *= mesh.size(mesh.mesh_dim_names.index(d))
    return size


def axis_index(grid, axis) -> int:
    """This rank's coordinate along the axis (its rank in the communicator)."""
    mesh = _mesh(grid)
    if tuple(_dims(axis)) == FLAT:
        return (mesh.get_local_rank(ROW_AXIS) * axis_size(mesh, COL_AXIS)
                + mesh.get_local_rank(COL_AXIS))
    return mesh.get_local_rank(axis)


def axis_allreduce(x: torch.Tensor, grid, axis, op: str = "sum") -> torch.Tensor:
    """listReduce analogue: elementwise reduce across the axis, result on
    every member (a new tensor)."""
    if op not in _OPS:
        raise ValueError(f"unsupported reduce op {op!r}")
    mesh = _mesh(grid)
    cplx = x.is_complex()
    if cplx and op != "sum":
        raise ValueError("max/min reductions need real tensors")
    w = _wire(x).clone()
    for d in _dims(axis):
        w = _all_reduce(w, mesh.get_group(d), _OPS[op])
    return torch.view_as_complex(w) if cplx else w


def axis_bcast(x: torch.Tensor, grid, axis, root: int = 0) -> torch.Tensor:
    """Broadcast ``x`` from the member at ``root`` to every member: the sum of
    a masked contribution (listBcast; the JAX package's masked psum)."""
    contrib = x if axis_index(grid, axis) == root else torch.zeros_like(x)
    return axis_allreduce(contrib, grid, axis)


def axis_allgather(x: torch.Tensor, grid, axis, dim: int = 0) -> torch.Tensor:
    """Concatenate every member's ``x`` along ``dim`` in axis order (the tiled
    all-gather)."""
    mesh = _mesh(grid)
    cplx = x.is_complex()
    w = _wire(x)
    dim = dim % x.ndim
    # FLAT gathers q first, then p: the result runs p-major, like (p, q)
    for d in reversed(_dims(axis)):
        w = torch.cat(_all_gather(w, mesh.get_group(d)), dim=dim)
    return torch.view_as_complex(w) if cplx else w


def axis_reduce_scatter(x: torch.Tensor, grid, axis, scatter_dim: int = 0
                        ) -> torch.Tensor:
    """Reduce across the axis, each member keeping its slice of
    ``scatter_dim`` (listReduce with each rank keeping its own tiles)."""
    mesh = _mesh(grid)
    cplx = x.is_complex()
    w = _wire(x.movedim(scatter_dim, 0)).clone()
    for d in _dims(axis):
        w = _reduce_scatter(w, mesh.get_group(d))
    out = torch.view_as_complex(w) if cplx else w
    return out.movedim(0, scatter_dim)


def ring_shift(x: torch.Tensor, grid, axis, shift: int = 1) -> torch.Tensor:
    """Rotate shards along one grid dim: member i receives member
    (i + shift) mod size's ``x`` (a Cannon/SUMMA pipeline step, the reference's
    lookahead panel sends).  One point-to-point pair per member."""
    mesh = _mesh(grid)
    size = axis_size(mesh, axis)
    shift %= size
    if shift == 0:
        return x.clone()
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    me = mesh.get_local_rank(axis)
    cplx = x.is_complex()
    w = _wire(x)
    dst, src = ranks[(me - shift) % size], ranks[(me + shift) % size]
    got = _send_recv(w, dst, torch.empty_like(w), src, group)
    if _LOG is not None:
        _p2p_record("collective-permute", ranks,
                    [(ranks[i], ranks[(i - shift) % size]) for i in range(size)],
                    [(w, dst)], [(got, src)])
    return torch.view_as_complex(got) if cplx else got


def _members(mesh, axis) -> List[int]:
    """World ranks of the members of ``axis`` that hold this rank, in axis
    order (FLAT: p-major)."""
    if tuple(_dims(axis)) == FLAT:
        return [int(r) for r in mesh.mesh.flatten()]
    return dist.get_process_group_ranks(mesh.get_group(axis))


def neighbor_exchange(to_right, to_left, grid, axis=FLAT):
    """Non-cyclic neighbour exchange along ``axis`` (the JAX package's
    ``ppermute`` over the pairs (i, i+1) and (i+1, i)): member i sends
    ``to_right`` to member i+1 and ``to_left`` to member i-1, and returns
    ``(from_left, from_right)``, shaped like ``to_right`` and ``to_left``
    (every member sends the same shapes).  An end member has no partner on
    one side: it sends nothing there and gets zeros, so member 0 receives
    nothing from the left and the last member nothing from the right.  Both
    directions ride one batch of point-to-point ops, so neighbours cannot
    deadlock."""
    mesh = _mesh(grid)
    ranks = _members(mesh, axis)
    me = axis_index(mesh, axis)
    sends, recvs, got = [], [], []
    for peer, send, like in ((me - 1, to_left, to_right), (me + 1, to_right, to_left)):
        if 0 <= peer < len(ranks):
            buf = torch.empty_like(_wire(like))
            sends.append((_wire(send), ranks[peer]))
            recvs.append((buf, ranks[peer]))
            got.append(torch.view_as_complex(buf) if like.is_complex() else buf)
        else:
            got.append(torch.zeros_like(like))
    _exchange(sends, recvs)
    if _LOG is not None:
        _p2p_record("collective-permute", ranks,
                    [p for i in range(len(ranks) - 1)
                     for p in ((ranks[i], ranks[i + 1]), (ranks[i + 1], ranks[i]))],
                    sends, recvs)
    return got[0], got[1]
