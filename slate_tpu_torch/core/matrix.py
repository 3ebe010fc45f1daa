"""Tiled matrix types over ``torch.Tensor`` — the L2 runtime.

Re-design of the reference's matrix hierarchy (``include/slate/BaseMatrix.hh``,
``Matrix.hh`` and the typed subclasses, ``internal/MatrixStorage.hh``):

* A matrix is **one tensor** on one device.  What survives of the reference's tile
  map is the *metadata*: the tile grid (mb/nb/rank lambdas, MatrixStorage.hh:339-342)
  and cheap views.
* Views are index arithmetic: ``sub`` (BaseMatrix.hh:104-106) and ``slice``
  (BaseMatrix.hh:110-121) share storage; ``transpose`` is a flag flip
  (Tile.hh:40-52).  ``.array`` returns a tensor view of the shared storage.
* Writes go into the shared :class:`MatrixStorage` in place.  Storage adopted from
  a caller (``from_array``) is copied once, on its first write, so a driver never
  mutates the caller's own tensor (copy-on-write).
* Entry points put new data on ``cuda`` unless the caller passes ``device=``;
  a tensor handed in keeps its device.  Without CUDA and without a ``device``
  they raise instead of falling back to the CPU.
* A wrapper bound to a process grid of more than one rank
  (:class:`slate_tpu_torch.parallel.ProcessGrid`) holds its storage as a
  ``DTensor`` in the grid's block layout, placed at construction as the
  reference installs the distribution in its constructors
  (MatrixStorage.hh:494-511); the drivers that have a distributed form run it
  (:func:`distribution_grid`), and reading ``.array`` gathers the whole matrix.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from . import grid as grid_funcs
from .exceptions import SlateError, slate_assert
from .types import Diag, GridOrder, Op, TileKind, Uplo


#: the fewest ranks a grid must have for a wrapper to bind to it: below, the
#: wrapper's storage stays whole and its drivers run on one device.
#: ``chip_smoke.py`` lowers it to 1 to drive the grid routes on one card.
BIND_MIN_RANKS = 2


def resolve_device(device=None) -> torch.device:
    """The entry-point device rule: ``cuda`` unless the caller names a device.

    Raises :class:`SlateError` when CUDA is asked for (explicitly or by default)
    and is not available — the port never falls back to the CPU quietly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SlateError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype, numpy dtype-like or name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def to_tensor(a, device=None, dtype=None) -> torch.Tensor:
    """Tensor for an entry-point operand.  A tensor keeps its device unless
    ``device`` is given; anything else (numpy, lists, scalars) is copied onto
    :func:`resolve_device`."""
    dtype = None if dtype is None else torch_dtype(dtype)
    if isinstance(a, torch.Tensor):
        if device is not None:
            a = a.to(resolve_device(device))
        return a if dtype is None else a.to(dtype)
    return torch.tensor(np.asarray(a), device=resolve_device(device), dtype=dtype)


def _like(value, ref: torch.Tensor) -> torch.Tensor:
    """``value`` as a tensor on ``ref``'s device (writes into shared storage);
    a DTensor stays one, and is placed by the storage."""
    from ..parallel.distribute import is_dist

    if is_dist(value):
        return value
    if is_dist(ref):
        ref = ref.to_local()
    if isinstance(value, torch.Tensor):
        return value.to(ref.device)
    return torch.as_tensor(np.asarray(value), device=ref.device)


def _expand_tile_sizes(total: int, spec):
    """Materialize a tile-size lambda / vector into an exact-cover tuple."""
    if spec is None:
        return None
    if callable(spec):
        sizes, s, i = [], 0, 0
        while s < total:
            b = int(spec(i))
            slate_assert(b > 0, f"tile size lambda returned {b} at index {i}")
            sizes.append(min(b, total - s))   # ragged last tile, like nb
            s += b
            i += 1
        spec = sizes
    sizes = [int(b) for b in spec]
    slate_assert(all(b > 0 for b in sizes) and sum(sizes) == total,
                 f"tile sizes {sizes} do not exactly cover dimension {total}")
    return tuple(sizes)


def _prefix(sizes):
    if sizes is None:
        return None
    offs = [0]
    for b in sizes:
        offs.append(offs[-1] + b)
    return tuple(offs)


def _offset_index(offs, offset: int, what: str) -> int:
    """Tile index whose boundary is exactly ``offset`` (views of non-uniform
    matrices must stay tile-aligned)."""
    k = _offset_index_or_none(offs, offset)
    slate_assert(k is not None,
                 f"{what}: offset {offset} is not a tile boundary of the "
                 f"non-uniform grid {offs}")
    return k


def _offset_index_or_none(offs, offset: int):
    import bisect

    k = bisect.bisect_left(offs, offset)
    return k if k < len(offs) and offs[k] == offset else None


class MatrixStorage:
    """Shared storage for a family of views (reference MatrixStorage.hh:150-1156).

    Holds the backing tensor (global logical matrix, untransposed), the tile-size
    lambdas and the tile->rank distribution lambda.  All views of one matrix hold a
    reference to one instance.  ``owned`` is False while the tensor may still be
    the caller's: the first :meth:`update` copies it.
    """

    __slots__ = ("array", "mb", "nb", "tile_rank", "grid", "kind", "p", "q",
                 "order", "default_rank_map", "mb_sizes", "nb_sizes",
                 "mb_offs", "nb_offs", "owned", "_whole", "pool", "__weakref__")

    def __init__(self, array: torch.Tensor, mb: int, nb: int,
                 p: int = 1, q: int = 1, order: GridOrder = GridOrder.Col,
                 grid: Any = None, kind: TileKind = TileKind.SlateOwned,
                 tile_rank: Optional[grid_funcs.TileRankFunc] = None,
                 tile_mb=None, tile_nb=None):
        self.array = array
        self._whole = None
        self.owned = kind != TileKind.UserOwned
        self.mb_sizes = _expand_tile_sizes(array.shape[-2], tile_mb)
        self.nb_sizes = _expand_tile_sizes(array.shape[-1], tile_nb)
        self.mb_offs = _prefix(self.mb_sizes)
        self.nb_offs = _prefix(self.nb_sizes)
        self.mb = int(mb) if self.mb_sizes is None else max(self.mb_sizes)
        self.nb = int(nb) if self.nb_sizes is None else max(self.nb_sizes)
        self.p = int(p)
        self.q = int(q)
        self.order = GridOrder.from_string(order)
        self.default_rank_map = tile_rank is None
        self.tile_rank = tile_rank or grid_funcs.process_2d_grid(self.order, self.p, self.q)
        self.grid = grid
        self.kind = kind
        self.pool = None
        self.place_on_grid()
        if _pool_tracking:
            _register_storage(self)

    def on_grid(self) -> bool:
        """Whether this storage lives on a process grid of at least
        :data:`BIND_MIN_RANKS` ranks that this rank belongs to."""
        g = self.grid
        return (g is not None and getattr(g, "size", 1) >= BIND_MIN_RANKS
                and getattr(g, "rank", -1) >= 0)

    def place_on_grid(self) -> None:
        """(Re)place the backing tensor onto the bound grid's block layout —
        each rank keeps its shard of a tensor that is the same on every rank
        (no data moves); a DTensor in another layout is gathered first."""
        self._whole = None
        if not self.on_grid() or self.array.ndim != 2:
            return
        from ..parallel.distribute import BLOCK, layout_of, local_block, wrap

        if layout_of(self.array) == BLOCK and self.array.device_mesh is self.grid.mesh:
            return
        self.array = wrap(local_block(self.array, self.grid), self.grid,
                          tuple(self.array.shape))

    def whole(self) -> torch.Tensor:
        """The backing tensor whole on this rank: itself off a grid, else the
        gathered DTensor (cached until the next write)."""
        if not self.on_grid():
            return self.array
        if self._whole is None:
            from ..parallel.distribute import gather

            self._whole = gather(self.array)
        return self._whole

    @property
    def m(self) -> int:
        return self.array.shape[-2]

    @property
    def n(self) -> int:
        return self.array.shape[-1]

    def update(self, row0: int, col0: int, block: torch.Tensor) -> None:
        """Write ``block`` into the backing tensor at (row0, col0).

        A block covering the whole matrix is adopted as the new backing tensor
        (no copy; it stays copy-on-write, since the caller may hold it).  A
        partial block is copied in place, after a one-time copy of storage the
        caller still owns."""
        if row0 == 0 and col0 == 0 and tuple(block.shape) == tuple(self.array.shape):
            self.array = block
            self.owned = False
            self.place_on_grid()
            return
        if self.on_grid():
            whole = self.whole().clone()
            whole[..., row0:row0 + block.shape[-2], col0:col0 + block.shape[-1]] = block
            self.array = whole
            self.place_on_grid()
            return
        if not self.owned:
            self.array = self.array.clone()
            self.owned = True
        self.array[..., row0:row0 + block.shape[-2],
                   col0:col0 + block.shape[-1]] = block


def _apply_op(t: torch.Tensor, op: Op) -> torch.Tensor:
    if op == Op.Trans:
        return t.transpose(-1, -2)
    if op == Op.ConjTrans:
        return t.mH.resolve_conj()
    return t


class BaseMatrix:
    """Shared view machinery for all matrix types (BaseMatrix.hh:39-795).

    A view is (storage, ioffset, joffset, m, n, op); ``uplo``/``diag`` live on the typed
    subclasses.  Offsets and extents are in **elements** of the untransposed storage.
    """

    uplo: Uplo = Uplo.General
    diag: Diag = Diag.NonUnit

    def __init__(self, storage: MatrixStorage, ioffset: int, joffset: int,
                 m: int, n: int, op: Op = Op.NoTrans):
        self.storage = storage
        self.ioffset = int(ioffset)
        self.joffset = int(joffset)
        self._m = int(m)   # extent in *storage* coordinates (before op)
        self._n = int(n)
        self.op = op

    # ----- shape ---------------------------------------------------------------
    @property
    def m(self) -> int:
        """Logical row count (after op), BaseMatrix.hh m()."""
        return self._n if self.op != Op.NoTrans else self._m

    @property
    def n(self) -> int:
        return self._m if self.op != Op.NoTrans else self._n

    @property
    def mb(self) -> int:
        return self.storage.nb if self.op != Op.NoTrans else self.storage.mb

    @property
    def nb(self) -> int:
        return self.storage.mb if self.op != Op.NoTrans else self.storage.nb

    def _row_tiles(self):
        """(base, count, sizes, offs) of the view's LOGICAL-row tiling in
        storage terms; sizes is None on the uniform path."""
        st = self.storage
        if self.op == Op.NoTrans:
            sizes, offs, off0, ext, ub = (st.mb_sizes, st.mb_offs,
                                          self.ioffset, self._m, st.mb)
        else:
            sizes, offs, off0, ext, ub = (st.nb_sizes, st.nb_offs,
                                          self.joffset, self._n, st.nb)
        return self._tiles_meta(sizes, offs, off0, ext, ub)

    def _col_tiles(self):
        st = self.storage
        if self.op == Op.NoTrans:
            sizes, offs, off0, ext, ub = (st.nb_sizes, st.nb_offs,
                                          self.joffset, self._n, st.nb)
        else:
            sizes, offs, off0, ext, ub = (st.mb_sizes, st.mb_offs,
                                          self.ioffset, self._m, st.mb)
        return self._tiles_meta(sizes, offs, off0, ext, ub)

    @staticmethod
    def _tiles_meta(sizes, offs, off0, ext, ub):
        if sizes is not None:
            b0 = _offset_index_or_none(offs, off0)
            b1 = _offset_index_or_none(offs, off0 + ext)
            if b0 is not None and b1 is not None:
                return b0, b1 - b0, sizes, offs
            # non-tile-aligned slice of a non-uniform matrix: tile metadata
            # re-bases to the max-block uniform fallback
        return None, grid_funcs.num_tiles(ext, ub), None, None

    @property
    def mt(self) -> int:
        """Row tile count (BaseMatrix.hh mt())."""
        return self._row_tiles()[1]

    @property
    def nt(self) -> int:
        return self._col_tiles()[1]

    def tileMb(self, i: int) -> int:
        b0, _, sizes, _ = self._row_tiles()
        if sizes is None:
            return grid_funcs.uniform_blocksize(self.m, self.mb)(i)
        return sizes[b0 + i]

    def tileNb(self, j: int) -> int:
        b0, _, sizes, _ = self._col_tiles()
        if sizes is None:
            return grid_funcs.uniform_blocksize(self.n, self.nb)(j)
        return sizes[b0 + j]

    def _logical_tile_offset(self, axis: int, t: int) -> int:
        """View-relative element offset of logical tile ``t`` along
        ``axis`` (0 = rows, 1 = cols)."""
        b0, _, sizes, offs = self._row_tiles() if axis == 0 else \
            self._col_tiles()
        if sizes is None:
            return t * (self.mb if axis == 0 else self.nb)
        return offs[b0 + t] - offs[b0]

    def tileRank(self, i: int, j: int) -> int:
        """Tile owner rank in the flattened p×q grid (MatrixStorage.hh:339).

        Only meaningful on tile-aligned views (anything built via ctor/sub/transpose).
        """
        st = self.storage
        if self.op != Op.NoTrans:
            i, j = j, i
        if st.mb_sizes is None:
            slate_assert(self.ioffset % st.mb == 0,
                         "tileRank on a non-tile-aligned slice view")
            si = self.ioffset // st.mb + i
        else:
            si = _offset_index(st.mb_offs, self.ioffset, "tileRank") + i
        if st.nb_sizes is None:
            slate_assert(self.joffset % st.nb == 0,
                         "tileRank on a non-tile-aligned slice view")
            sj = self.joffset // st.nb + j
        else:
            sj = _offset_index(st.nb_offs, self.joffset, "tileRank") + j
        return st.tile_rank(si, sj)

    def tileIsLocal(self, i: int, j: int) -> bool:
        """Whether tile (i, j) is owned by this process's rank on the grid
        (BaseMatrix::tileIsLocal).  Without a grid everything is local."""
        g = self.storage.grid
        rank = 0 if g is None else getattr(g, "rank", 0)
        return self.tileRank(i, j) == rank

    @property
    def dtype(self) -> torch.dtype:
        return self.storage.array.dtype

    @property
    def device(self) -> torch.device:
        return self.storage.array.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.m, self.n)

    def gridinfo(self) -> Tuple[GridOrder, int, int]:
        """(order, p, q) of the process grid (BaseMatrix.hh:161-164)."""
        return self.storage.order, self.storage.p, self.storage.q

    def _root_default_map(self) -> bool:
        """Whether this view is its storage's root with the default 2D
        block-cyclic map on a uniform tile grid (the native fast path)."""
        st = self.storage
        return (self.op == Op.NoTrans and self.ioffset == 0 and self.joffset == 0
                and st.default_rank_map and st.mb_sizes is None
                and st.nb_sizes is None)

    def owner_map(self) -> np.ndarray:
        """(mt, nt) int32 array of tile owners — the materialized tile directory
        (MatrixStorage.hh's map).  Root views use the native runtime's fill
        (:mod:`slate_tpu_torch.native`); transposed, offset, non-uniform and
        custom-map views go through tileRank so the view semantics stay exact."""
        if self._root_default_map():
            from .. import native

            order, p, q = self.gridinfo()
            return native.owner_map(self.mt, self.nt, p, q, order)
        return np.array([[self.tileRank(i, j) for j in range(self.nt)]
                         for i in range(self.mt)], dtype=np.int32).reshape(
                             self.mt, self.nt)

    def local_tiles(self, rank: int) -> np.ndarray:
        """(k, 2) tile indices owned by ``rank`` (the per-rank directory walk
        the reference does when enumerating local tiles)."""
        if self._root_default_map():
            from .. import native

            order, p, q = self.gridinfo()
            return native.local_tiles(self.mt, self.nt, p, q, rank, order)
        ii, jj = np.nonzero(self.owner_map() == rank)
        return np.stack([ii, jj], axis=1).astype(np.int64)

    # ----- data access ---------------------------------------------------------
    @property
    def array(self) -> torch.Tensor:
        """The logical view (op applied) — a view of shared storage for
        NoTrans/Trans, a conjugated copy for ConjTrans of complex data."""
        a = self.storage.whole()[..., self.ioffset:self.ioffset + self._m,
                                 self.joffset:self.joffset + self._n]
        return _apply_op(a, self.op)

    def _whole_on_grid(self) -> bool:
        """Whether this view is its whole storage and the storage is on a grid."""
        st = self.storage
        return (st.on_grid() and self.ioffset == 0 and self.joffset == 0
                and (self._m, self._n) == (st.m, st.n))

    def dist_array(self):
        """The operand a distributed driver takes: for a whole view of
        grid-bound storage, the logical matrix in the block layout (the storage
        DTensor itself, or for a transposed view its transpose by one block
        exchange); else :attr:`array`."""
        st = self.storage
        if not self._whole_on_grid():
            return self.array
        if self.op == Op.NoTrans:
            return st.array
        from ..parallel.distribute import transpose_local, wrap

        return wrap(transpose_local(st.array.to_local(), st.grid, st.m, st.n,
                                    conj=self.op == Op.ConjTrans),
                    st.grid, (st.n, st.m))

    def set_array(self, value) -> None:
        """Write the logical view back to shared storage."""
        from ..parallel.distribute import gather, is_dist

        if is_dist(value) and not (self._whole_on_grid() and self.op == Op.NoTrans):
            value = gather(value)   # only a whole grid-bound view takes a DTensor
        value = _like(value, self.storage.array)
        slate_assert(tuple(value.shape[-2:]) == (self.m, self.n),
                     f"shape mismatch: view {self.shape}, value {tuple(value.shape)}")
        self.storage.update(self.ioffset, self.joffset, _apply_op(value, self.op))

    def __call__(self, i: int, j: int) -> torch.Tensor:
        """Read tile (i, j) — the reference's ``A(i, j)`` tile accessor."""
        return self.tile(i, j)

    def _tile_storage_coords(self, i: int, j: int):
        """Map logical tile (i, j) to a storage-coordinate slice (op un-applied)."""
        mb_log, nb_log = self.tileMb(i), self.tileNb(j)
        io, jo = self._logical_tile_offset(0, i), self._logical_tile_offset(1, j)
        if self.op != Op.NoTrans:
            io, jo = jo, io
            mb_log, nb_log = nb_log, mb_log
        return (self.ioffset + io, self.joffset + jo, mb_log, nb_log)

    def tile(self, i: int, j: int) -> torch.Tensor:
        """Slices storage directly and applies op to the single tile."""
        io, jo, mb_s, nb_s = self._tile_storage_coords(i, j)
        return _apply_op(self.storage.whole()[..., io:io + mb_s, jo:jo + nb_s], self.op)

    def set_tile(self, i: int, j: int, value) -> None:
        io, jo, mb_s, nb_s = self._tile_storage_coords(i, j)
        value = _like(value, self.storage.array)
        slate_assert(tuple(value.shape[-2:]) == ((nb_s, mb_s) if self.op != Op.NoTrans
                                                 else (mb_s, nb_s)),
                     f"tile shape mismatch at ({i},{j})")
        self.storage.update(io, jo, _apply_op(value, self.op))

    # ----- views ---------------------------------------------------------------
    def _make_view(self, ioffset, joffset, m, n, op) -> "BaseMatrix":
        view = object.__new__(type(self))
        BaseMatrix.__init__(view, self.storage, ioffset, joffset, m, n, op)
        view.uplo = getattr(self, "uplo", Uplo.General)
        view.diag = getattr(self, "diag", Diag.NonUnit)
        for attr in ("_kl", "_ku", "kd"):
            if hasattr(self, attr):
                setattr(view, attr, getattr(self, attr))
        return view

    def sub(self, i1: int, i2: int, j1: int, j2: int) -> "BaseMatrix":
        """Sub-matrix over inclusive tile indices [i1..i2] x [j1..j2]
        (BaseMatrix.hh:104-106)."""
        slate_assert(0 <= i1 and i2 < self.mt and 0 <= j1 and j2 < self.nt,
                     f"sub({i1},{i2},{j1},{j2}) out of range {self.mt}x{self.nt}")
        m = sum(self.tileMb(i) for i in range(i1, i2 + 1))
        n = sum(self.tileNb(j) for j in range(j1, j2 + 1))
        io, jo = self._logical_tile_offset(0, i1), self._logical_tile_offset(1, j1)
        if self.op != Op.NoTrans:
            io, jo, m, n = jo, io, n, m
        return self._make_view(self.ioffset + io, self.joffset + jo, m, n, self.op)

    def slice(self, row1: int, row2: int, col1: int, col2: int) -> "BaseMatrix":
        """Sub-matrix over inclusive element indices (BaseMatrix.hh:110-121)."""
        slate_assert(0 <= row1 <= row2 < self.m and 0 <= col1 <= col2 < self.n,
                     f"slice({row1},{row2},{col1},{col2}) out of range "
                     f"{self.m}x{self.n}")
        m, n = row2 - row1 + 1, col2 - col1 + 1
        io, jo = row1, col1
        if self.op != Op.NoTrans:
            io, jo, m, n = jo, io, n, m
        return self._make_view(self.ioffset + io, self.joffset + jo, m, n, self.op)

    def transpose(self) -> "BaseMatrix":
        """Logical transpose — a flag flip, no data motion (Tile.hh:40-52)."""
        if self.op == Op.ConjTrans:
            raise SlateError("transpose of conj-transposed view not supported; "
                             "matches reference restriction")
        op = Op.Trans if self.op == Op.NoTrans else Op.NoTrans
        v = self._make_view(self.ioffset, self.joffset, self._m, self._n, op)
        v.uplo = _flip_uplo(self.uplo)
        return v

    def conj_transpose(self) -> "BaseMatrix":
        if self.op == Op.Trans:
            raise SlateError("conj_transpose of transposed view not supported")
        op = Op.ConjTrans if self.op == Op.NoTrans else Op.NoTrans
        v = self._make_view(self.ioffset, self.joffset, self._m, self._n, op)
        v.uplo = _flip_uplo(self.uplo)
        return v

    @property
    def T(self):
        return self.transpose()

    @property
    def H(self):
        return self.conj_transpose()

    def __repr__(self) -> str:
        extra = "" if self.uplo == Uplo.General else f", uplo={self.uplo}"
        return (f"{type(self).__name__}({self.m}x{self.n}, mb={self.mb}, nb={self.nb}, "
                f"mt={self.mt}, nt={self.nt}, op={self.op}{extra}, dtype={self.dtype}, "
                f"device={self.device})")


def tri_to_full(a: torch.Tensor, lower: bool, herm: bool) -> torch.Tensor:
    """Full symmetric/Hermitian tensor from the stored triangle (batch-dim
    aware).  The Hermitian case real-casts the diagonal — BLAS her* semantics
    ignore the imaginary part of a Hermitian diagonal.  Returns a new tensor."""
    strict = torch.tril(a, -1) if lower else torch.triu(a, 1)
    mirror = strict.transpose(-1, -2)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    if herm and a.is_complex():
        mirror = mirror.conj()
        diag = diag.real.to(a.dtype)
    full = strict + mirror
    torch.diagonal(full, dim1=-2, dim2=-1).copy_(diag)
    return full


def _flip_uplo(uplo: Uplo) -> Uplo:
    if uplo == Uplo.Lower:
        return Uplo.Upper
    if uplo == Uplo.Upper:
        return Uplo.Lower
    return uplo


def _zeros(m: int, n: int, dtype, device) -> torch.Tensor:
    return torch.zeros((m, n), dtype=torch_dtype(dtype), device=resolve_device(device))


# ---------------------------------------------------------------------------
# Typed matrices
# ---------------------------------------------------------------------------


class Matrix(BaseMatrix):
    """General m×n matrix (include/slate/Matrix.hh:31-164)."""

    def __init__(self, m: int, n: int, nb: int, p: int = 1, q: int = 1,
                 mb: Optional[int] = None, order: GridOrder = GridOrder.Col,
                 grid: Any = None, dtype=torch.float32, device=None,
                 _storage: MatrixStorage = None):
        if _storage is not None:
            BaseMatrix.__init__(self, _storage, 0, 0, _storage.m, _storage.n)
            return
        storage = MatrixStorage(_zeros(m, n, dtype, device), mb or nb, nb, p, q,
                                order, grid)
        BaseMatrix.__init__(self, storage, 0, 0, m, n)

    @classmethod
    def from_array(cls, a, nb: int = 256, p: int = 1, q: int = 1,
                   mb: Optional[int] = None, order: GridOrder = GridOrder.Col,
                   grid: Any = None, tile_rank=None,
                   tile_mb=None, tile_nb=None, device=None) -> "Matrix":
        """Wrap existing data (reference fromLAPACK, Matrix.hh:293).  A tensor is
        adopted as UserOwned origin data (copied on first write); other data is
        copied onto ``device`` (default ``cuda``).  ``tile_mb``/``tile_nb``
        (callable i -> size or size vector) install non-uniform tile grids;
        ``tile_rank`` a custom tile -> rank lambda."""
        a = to_tensor(a, device)
        slate_assert(a.ndim == 2, "from_array expects a 2-D array")
        storage = MatrixStorage(a, mb or nb, nb, p, q, order, grid,
                                kind=TileKind.UserOwned, tile_rank=tile_rank,
                                tile_mb=tile_mb, tile_nb=tile_nb)
        return cls(0, 0, nb, _storage=storage)

    def empty_like(self, m: Optional[int] = None, n: Optional[int] = None,
                   nb: Optional[int] = None, dtype=None) -> "Matrix":
        """New zeroed matrix with this one's distribution and device
        (Matrix.hh emptyLike:117).  A source non-uniform tile grid is carried
        over when the shape and blocking are unchanged."""
        s = self.storage
        mm = self.m if m is None else m
        nn = self.n if n is None else n
        dt = dtype or self.dtype
        if (nb is None and (s.mb_sizes is not None or s.nb_sizes is not None)
                and mm == s.m and nn == s.n and self.op == Op.NoTrans):
            storage = MatrixStorage(_zeros(mm, nn, dt, self.device), s.mb, s.nb,
                                    s.p, s.q, s.order, s.grid,
                                    tile_rank=(None if s.default_rank_map
                                               else s.tile_rank),
                                    tile_mb=s.mb_sizes, tile_nb=s.nb_sizes)
            return Matrix(0, 0, s.nb, _storage=storage)
        return Matrix(mm, nn, nb or self.nb, s.p, s.q, order=s.order, grid=s.grid,
                      dtype=dt, device=self.device)


class BaseTrapezoidMatrix(BaseMatrix):
    """Upper/lower trapezoidal storage view (include/slate/BaseTrapezoidMatrix.hh)."""

    def __init__(self, uplo: Uplo, m: int = 0, n: int = 0, nb: int = 256, p: int = 1,
                 q: int = 1, order: GridOrder = GridOrder.Col, grid: Any = None,
                 dtype=torch.float32, device=None, _storage: MatrixStorage = None,
                 diag: Diag = Diag.NonUnit):
        if _storage is not None:
            BaseMatrix.__init__(self, _storage, 0, 0, _storage.m, _storage.n)
        else:
            storage = MatrixStorage(_zeros(m, n, dtype, device), nb, nb, p, q,
                                    order, grid)
            BaseMatrix.__init__(self, storage, 0, 0, m, n)
        self.uplo = Uplo.from_string(uplo)
        self.diag = Diag.from_string(diag)
        slate_assert(self.uplo in (Uplo.Lower, Uplo.Upper), "uplo must be lower/upper")

    @classmethod
    def from_array(cls, uplo, a, nb: int = 256, p: int = 1, q: int = 1,
                   order: GridOrder = GridOrder.Col, grid: Any = None,
                   device=None, **kw):
        a = to_tensor(a, device)
        storage = MatrixStorage(a, nb, nb, p, q, order, grid, kind=TileKind.UserOwned)
        return cls(uplo, _storage=storage, **kw)

    def masked_array(self) -> torch.Tensor:
        """The logical view with the unreferenced triangle zeroed (and unit diagonal
        substituted if diag == Unit) — the compute-side canonical form."""
        a = self.array
        a = torch.tril(a) if self.uplo == Uplo.Lower else torch.triu(a)
        if self.diag == Diag.Unit:
            torch.diagonal(a, dim1=-2, dim2=-1).fill_(1)
        return a


class TrapezoidMatrix(BaseTrapezoidMatrix):
    """include/slate/TrapezoidMatrix.hh."""


class TriangularMatrix(BaseTrapezoidMatrix):
    """Square triangular matrix (include/slate/TriangularMatrix.hh, 684 LoC)."""

    def __init__(self, uplo, n: int = 0, nb: int = 256, *args, **kw):
        super().__init__(uplo, n, n, nb, *args, **kw)


class SymmetricMatrix(BaseTrapezoidMatrix):
    """Symmetric matrix, one triangle stored (include/slate/SymmetricMatrix.hh)."""

    def __init__(self, uplo, n: int = 0, nb: int = 256, *args, **kw):
        super().__init__(uplo, n, n, nb, *args, **kw)

    def full_array(self) -> torch.Tensor:
        """Symmetrize from the stored triangle: A = tril(A) + tril(A,-1)^T etc."""
        return tri_to_full(self.array, self.uplo == Uplo.Lower, herm=False)


class HermitianMatrix(BaseTrapezoidMatrix):
    """Hermitian matrix (include/slate/HermitianMatrix.hh)."""

    def __init__(self, uplo, n: int = 0, nb: int = 256, *args, **kw):
        super().__init__(uplo, n, n, nb, *args, **kw)

    def full_array(self) -> torch.Tensor:
        return tri_to_full(self.array, self.uplo == Uplo.Lower, herm=True)


class BaseBandMatrix(BaseMatrix):
    """Band matrix base (include/slate/BaseBandMatrix.hh, 368 LoC).

    The backing tensor is dense with (kl, ku) metadata; band drivers only touch
    elements inside the band."""

    def __init__(self, m, n, kl, ku, nb, p=1, q=1, order=GridOrder.Col, grid=None,
                 dtype=torch.float32, device=None, _storage=None):
        if _storage is not None:
            BaseMatrix.__init__(self, _storage, 0, 0, _storage.m, _storage.n)
        else:
            storage = MatrixStorage(_zeros(m, n, dtype, device), nb, nb, p, q,
                                    order, grid)
            BaseMatrix.__init__(self, storage, 0, 0, m, n)
        self._kl = int(kl)   # storage-orientation bandwidths
        self._ku = int(ku)

    @property
    def kl(self) -> int:
        """Logical lower bandwidth (swaps with ku on transposed views)."""
        return self._ku if self.op != Op.NoTrans else self._kl

    @property
    def ku(self) -> int:
        return self._kl if self.op != Op.NoTrans else self._ku

    def band_mask(self) -> torch.Tensor:
        r = torch.arange(self.m, device=self.device)[:, None]
        c = torch.arange(self.n, device=self.device)[None, :]
        return (c - r <= self.ku) & (r - c <= self.kl)

    def masked_array(self) -> torch.Tensor:
        a = self.array
        return torch.where(self.band_mask(), a, torch.zeros((), dtype=a.dtype,
                                                            device=a.device))


class BandMatrix(BaseBandMatrix):
    """include/slate/BandMatrix.hh (265 LoC)."""


class TriangularBandMatrix(BaseBandMatrix):
    """include/slate/TriangularBandMatrix.hh (374 LoC)."""

    def __init__(self, uplo, n, kd, nb, **kw):
        uplo = Uplo.from_string(uplo)
        kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
        super().__init__(n, n, kl, ku, nb, **kw)
        self.uplo = uplo
        self.kd = kd


class HermitianBandMatrix(BaseBandMatrix):
    """include/slate/HermitianBandMatrix.hh (358 LoC)."""

    def __init__(self, uplo, n, kd, nb, **kw):
        uplo = Uplo.from_string(uplo)
        kl, ku = (kd, 0) if uplo == Uplo.Lower else (0, kd)
        super().__init__(n, n, kl, ku, nb, **kw)
        self.uplo = uplo
        self.kd = kd


# ---------------------------------------------------------------------------
# workspace-pool accounting (reference Memory.cc + reserveDeviceWorkspace): the
# caching allocator owns the device memory, so the pool tracks tile-granular
# budget for the debug invariants (Debug::printNumFreeMemBlocks).  Opt-in —
# nothing is tracked unless enabled — because drivers build wrappers in hot
# paths.

_pool_tracking = False
_live_storages: Any = None


def enable_pool_tracking(on: bool = True) -> None:
    """Track every MatrixStorage built from now on in a per-storage
    :class:`~slate_tpu_torch.native.MemoryPool` (one block per tile) and a
    process-wide weak registry — the data behind
    ``utils.debug.check_no_leaks`` and :func:`live_workspace_report`."""
    global _pool_tracking, _live_storages
    _pool_tracking = bool(on)
    if on and _live_storages is None:
        import weakref

        _live_storages = weakref.WeakSet()


def _register_storage(s: MatrixStorage) -> None:
    from .. import native

    arr = s.array
    mt = -(-arr.shape[-2] // s.mb) if arr.ndim >= 2 else 1
    nt = -(-arr.shape[-1] // s.nb) if arr.ndim >= 2 else 1
    # capacity = the storage's resident tiles; blocks are allocated only for
    # transient workspace (drivers may pool.alloc()/free() around scratch), so
    # a healthy storage keeps in_use == 0 and check_no_leaks stays usable
    s.pool = native.MemoryPool(s.mb * s.nb * arr.element_size(), max(mt * nt, 1))
    _live_storages.add(s)


def live_workspace_report():
    """(n_storages, total_resident_bytes) across live tracked storages — the
    Debug::printNumFreeMemBlocks analogue (capacity = resident tiles; any
    nonzero pool.in_use on top is outstanding workspace)."""
    if not _live_storages:
        return 0, 0
    total = count = 0
    for s in list(_live_storages):
        pool = s.pool
        if pool is not None:
            total += pool.capacity * pool.block_bytes
            count += 1
    return count, total


# ---------------------------------------------------------------------------
# Helpers used across drivers
# ---------------------------------------------------------------------------


def distribution_grid(*operands):
    """The shared ProcessGrid (of at least :data:`BIND_MIN_RANKS` ranks)
    attached to any wrapper operand, or None.

    Drivers consult this to route to the ``parallel`` implementations — the
    reference consuming ``tileRank``/``tileDevice`` installed at matrix
    construction (MatrixStorage.hh:494-511).  Mixing wrappers bound to
    different grids is an error, like mixing BLACS contexts."""
    g = None
    for op in operands:
        if isinstance(op, BaseMatrix):
            og = op.storage.grid
            if og is not None and getattr(og, "size", 1) >= BIND_MIN_RANKS:
                if g is not None and og is not g:
                    raise SlateError(
                        "operands are distributed on different process grids")
                g = og
    return g


def as_array(A, device=None) -> torch.Tensor:
    """Accept Matrix-likes or raw arrays at API boundaries; return the logical
    tensor (raw non-tensor data goes onto ``device``, default ``cuda``)."""
    if isinstance(A, BaseMatrix):
        return A.array
    if isinstance(A, torch.Tensor) and type(A) is not torch.Tensor:
        from ..parallel.distribute import gather

        A = gather(A)           # a distributed result handed to a local driver
    return to_tensor(A, device)


def dist_operand(X):
    """The operand a distributed driver takes: a wrapper's
    :meth:`~BaseMatrix.dist_array` (its block-layout DTensor when it lives
    whole on a grid), or a tensor as it is."""
    return X.dist_array() if isinstance(X, BaseMatrix) else X


def write_back(A, value: torch.Tensor):
    """Write a driver result back into a Matrix wrapper (no-op passthrough for raw
    arrays — the functional-style API returns the value either way)."""
    if isinstance(A, BaseMatrix):
        A.set_array(value)
    return value


_WRAPPERS = {c.__name__: c for c in (
    Matrix, TrapezoidMatrix, TriangularMatrix, SymmetricMatrix, HermitianMatrix,
    BandMatrix, TriangularBandMatrix, HermitianBandMatrix)}


def from_reference_state(d: dict, device=None, grid=None) -> BaseMatrix:
    """Rebuild the counterpart wrapper of a JAX-package wrapper from a plain dict.

    Keys: ``class`` (wrapper class name), ``array`` (the untransposed storage
    array, numpy — a grid-bound wrapper's global array), ``mb``/``nb``, and as
    the class needs them ``uplo``, ``diag``, ``op``, ``kl``/``ku`` (band),
    ``kd`` (triangular/Hermitian band), the view window
    ``ioffset``/``joffset``/``m``/``n`` in storage coordinates (default: the
    whole storage) and ``gridinfo`` (order, p, q).  ``grid`` — a
    :class:`~slate_tpu_torch.parallel.ProcessGrid` or ``(p, q, order)`` —
    binds the wrapper to that grid, every rank keeping its shard.  Options
    carry across with ``Options.make(dict)``."""
    cls = _WRAPPERS.get(d["class"])
    if cls is None:
        raise SlateError(f"no wrapper class named {d['class']!r}")
    a = to_tensor(d["array"], device)
    nb = int(d.get("nb", 256))
    if grid is not None and not hasattr(grid, "mesh"):
        from ..parallel.mesh import ProcessGrid

        grid = ProcessGrid.cached(grid[0], grid[1], device=a.device,
                                  order=grid[2] if len(grid) > 2 else GridOrder.Col)
    order, p, q = d.get("gridinfo", (GridOrder.Col, 1, 1))
    storage = MatrixStorage(a, int(d.get("mb") or nb), nb, int(p), int(q), order,
                            grid, kind=TileKind.UserOwned)
    if cls is Matrix:
        w = Matrix(0, 0, nb, _storage=storage)
    elif issubclass(cls, BaseTrapezoidMatrix):
        w = cls(d.get("uplo", "lower"), _storage=storage,
                diag=d.get("diag", Diag.NonUnit))
    elif cls is BandMatrix:
        w = BandMatrix(a.shape[-2], a.shape[-1], d["kl"], d["ku"], nb,
                       _storage=storage)
    else:
        w = cls(d.get("uplo", "lower"), a.shape[-1], d["kd"], nb, _storage=storage)
    op = Op.from_string(d.get("op", Op.NoTrans))
    io, jo = int(d.get("ioffset", 0)), int(d.get("joffset", 0))
    m, n = int(d.get("m", a.shape[-2] - io)), int(d.get("n", a.shape[-1] - jo))
    if (op, io, jo, m, n) != (Op.NoTrans, 0, 0, a.shape[-2], a.shape[-1]):
        uplo = w.uplo
        w = w._make_view(io, jo, m, n, op)
        w.uplo = uplo
    return w


def _index_tensor(idx, device) -> torch.Tensor:
    return torch.tensor(np.asarray(idx), dtype=torch.int64, device=device)


def from_reference_factors(d: dict, device=None):
    """Rebuild a JAX-package factorization as the port's, from a plain dict —
    the factorization counterpart of :func:`from_reference_state`.

    * ``{"LU": ..., "perm": ...}`` (what ``slate_tpu.getrf`` returns, as numpy;
      ``perm`` may be None) gives ``(LU, perm)`` tensors, ``perm`` int64, for
      ``getrs``/``getri``/``gecondest``;
    * ``{"packed": ..., "tau": ..., "T": ...}`` (a ``TriangularFactors``)
      gives the port's ``TriangularFactors`` for ``unmqr``/``unmlq``
      (:meth:`slate_tpu_torch.linalg.qr.TriangularFactors.from_reference`);
    * ``{"lu": ..., "perms": ..., "kl", "ku", "nb"}`` (a ``BandLU``, its
      ``_asdict()`` as numpy) gives the port's ``BandLU`` for ``gbtrs``;
    * ``{"L", "T", "T_fac", "perm", "inv_perm", "nb"}`` (a
      ``HermitianFactors``, ``T_fac`` a BandLU dict) gives the port's
      ``HermitianFactors`` for ``hetrs``.

    Placed on ``device`` (default ``cuda``)."""
    if "LU" in d:
        lu_ = to_tensor(d["LU"], device)
        perm = d.get("perm")
        return lu_, None if perm is None else torch.tensor(
            np.asarray(perm), dtype=torch.int64, device=lu_.device)
    if "packed" in d:
        from ..linalg.qr import TriangularFactors
        return TriangularFactors.from_reference(d, device)
    if "perms" in d:
        from ..linalg.band import BandLU
        lu_ = to_tensor(d["lu"], device)
        return BandLU(lu=lu_, perms=_index_tensor(d["perms"], lu_.device),
                      kl=int(d["kl"]), ku=int(d["ku"]), nb=int(d["nb"]))
    if "T_fac" in d:
        from ..linalg.indefinite import HermitianFactors
        L = to_tensor(d["L"], device)
        return HermitianFactors(
            L=L, T=to_tensor(d["T"], L.device),
            T_fac=from_reference_factors(d["T_fac"], L.device),
            perm=_index_tensor(d["perm"], L.device),
            inv_perm=_index_tensor(d["inv_perm"], L.device), nb=int(d["nb"]))
    raise SlateError(f"no factorization with keys {sorted(d)}")
