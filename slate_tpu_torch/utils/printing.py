"""Distributed-matrix printing (≅ src/print.cc, 1298 LoC).

The reference gathers tiles to rank 0 per block row (print.cc:508) and prints with
verbosity levels 0-4 selected by ``Option::PrintVerbose`` (enums.hh:477-488):

    0  nothing
    1  one metadata line (type, dims, tile size, grid)
    2  abbreviated corners (edgeitems window with ellipsis)
    3  full matrix
    4  full matrix with tile-boundary rules

Here the matrix is brought to the host once, as numpy (a grid-bound wrapper's
shards gathered first), and rendered there, so the text for the same values is
the JAX package's, character for character.  Level 1 moves no data.
"""

from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from ..core.matrix import BaseMatrix

__all__ = ["print_matrix"]


def _host(A) -> np.ndarray:
    """The logical matrix as numpy, in one device-to-host copy (a grid-bound
    wrapper or a DTensor gathered first)."""
    if isinstance(A, BaseMatrix):
        A = A.array
    if isinstance(A, torch.Tensor):
        from ..parallel.distribute import gather, is_dist

        if is_dist(A):
            A = gather(A)
        return A.detach().resolve_conj().cpu().numpy()
    return np.asarray(A)


def _fmt(x, width: int, precision: int) -> str:
    if np.iscomplexobj(np.asarray(x)):
        return f"{x.real:{width}.{precision}f}{x.imag:+.{precision}f}i"
    return f"{float(x):{width}.{precision}f}"


def _rows(a, width, precision, tile_rows=None, tile_cols=None):
    m, n = a.shape
    lines = []
    for i in range(m):
        cells = [_fmt(a[i, j], width, precision) for j in range(n)]
        if tile_cols:
            out = []
            for j, c in enumerate(cells):
                out.append(c)
                if (j + 1) in tile_cols and j + 1 < n:
                    out.append("|")
            cells = out
        lines.append("  ".join(cells))
        if tile_rows and (i + 1) in tile_rows and i + 1 < m:
            lines.append("-" * max(len(lines[-1]), 1))
    return lines


def print_matrix(label: str, A, verbose: int = 3, width: int = 10,
                 precision: int = 4, edgeitems: int = 3,
                 file=None) -> Optional[str]:
    """Print a (distributed) matrix at the requested verbosity; returns the
    rendered string (also written to ``file``, default stdout).
    ≅ slate::print(label, A, opts) with Option::PrintVerbose/Width/Precision."""
    file = file or sys.stdout
    if verbose <= 0:
        return None
    out = []
    a = None
    if isinstance(A, BaseMatrix):
        order, p, q = A.gridinfo()
        meta = (f"% {label}: {type(A).__name__} {A.m}x{A.n}, "
                f"tile {A.mb}x{A.nb}, grid {p}x{q} ({order})")
    else:
        if isinstance(A, torch.Tensor):   # the line needs no copy of the data
            shape, dtype = tuple(A.shape), torch.empty(0, dtype=A.dtype).numpy().dtype
        else:
            a = np.asarray(A)
            shape, dtype = a.shape, a.dtype
        meta = f"% {label}: array {'x'.join(map(str, shape))} {dtype}"
    out.append(meta)

    if verbose >= 2:
        a = _host(A) if a is None else a
        m, n = a.shape[-2:]
        if verbose == 2 and (m > 2 * edgeitems + 1 or n > 2 * edgeitems + 1):
            with np.printoptions(edgeitems=edgeitems, threshold=0,
                                 precision=precision, suppress=True):
                out.append(str(a))
        else:
            tile_rows = tile_cols = None
            if verbose >= 4 and isinstance(A, BaseMatrix):
                # cumulative tileMb/tileNb — correct for non-uniform grids
                # (scalar mb/nb are max block sizes there, not boundaries)
                acc_r, acc_c = 0, 0
                tile_rows, tile_cols = set(), set()
                for i in range(A.mt):
                    acc_r += A.tileMb(i)
                    tile_rows.add(min(acc_r, m))
                for j in range(A.nt):
                    acc_c += A.tileNb(j)
                    tile_cols.add(min(acc_c, n))
            out.append(f"{label} = [")
            out.extend(_rows(a, width, precision, tile_rows, tile_cols))
            out.append("]")
    text = "\n".join(out)
    print(text, file=file)
    return text
