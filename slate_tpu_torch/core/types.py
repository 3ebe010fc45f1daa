"""Enums and per-call options (the PyTorch port keeps the JAX package's copy
of this module unchanged apart from dtype canonicalisation).

Re-design of the reference's enum/option system
(``include/slate/enums.hh:38-498``, ``include/slate/types.hh:32-271``).

The reference passes a ``std::map<Option, OptionValue>`` to every driver; here we use a
frozen dataclass :class:`Options` with typed fields and an ``opts.replace(...)`` /
``Options(**dict)`` interface.  Every enum supports the same string round-trip the
reference provides via ``to_string``/``from_string`` helpers (``enums.hh:61-455``):
``Op.from_string("t") == Op.Trans`` and ``str(Op.Trans) == "trans"``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional


class _StrEnum(enum.Enum):
    """Enum with case-insensitive string round trip (mirrors enums.hh *2str/str2* pairs)."""

    def __str__(self) -> str:  # noqa: D105
        return self.value

    @classmethod
    def from_string(cls, s: "str | _StrEnum"):
        if isinstance(s, cls):
            return s
        key = str(s).strip().lower()
        for member in cls:
            if member.value == key or member.name.lower() == key:
                return member
        # single-letter shorthands used throughout the reference tester CLI
        short = getattr(cls, "_shorthand", None)
        if short is not None and key in short:
            return short[key]
        raise ValueError(f"no {cls.__name__} named {s!r}")


class Op(_StrEnum):
    """Transposition flag (enums.hh via blaspp; Tile.hh:40-52 makes transpose a flag flip)."""

    NoTrans = "notrans"
    Trans = "trans"
    ConjTrans = "conjtrans"


Op._shorthand = {"n": Op.NoTrans, "t": Op.Trans, "c": Op.ConjTrans}


class Uplo(_StrEnum):
    """Which triangle is referenced (blaspp enum used pervasively in BaseMatrix)."""

    Upper = "upper"
    Lower = "lower"
    General = "general"


Uplo._shorthand = {"u": Uplo.Upper, "l": Uplo.Lower, "g": Uplo.General}


class Diag(_StrEnum):
    NonUnit = "nonunit"
    Unit = "unit"


Diag._shorthand = {"n": Diag.NonUnit, "u": Diag.Unit}


class Side(_StrEnum):
    Left = "left"
    Right = "right"


Side._shorthand = {"l": Side.Left, "r": Side.Right}


class Layout(_StrEnum):
    """Physical tile layout (Tile.hh). On TPU XLA owns layout; kept for API parity only."""

    ColMajor = "colmajor"
    RowMajor = "rowmajor"


class Norm(_StrEnum):
    """Matrix norm kind (matches lapack norms used by internal_genorm.cc etc.)."""

    One = "one"
    Two = "two"
    Inf = "inf"
    Fro = "fro"
    Max = "max"


Norm._shorthand = {"1": Norm.One, "o": Norm.One, "2": Norm.Two, "i": Norm.Inf,
                   "f": Norm.Fro, "e": Norm.Fro, "m": Norm.Max}


class NormScope(_StrEnum):
    """Scope of a norm computation (enums.hh NormScope; Columns used by colNorms)."""

    Columns = "columns"
    Rows = "rows"
    Matrix = "matrix"


class Target(_StrEnum):
    """Execution target (enums.hh:38-44).

    The reference has {HostTask, HostNest, HostBatch, Devices}. On TPU there is a single
    compute fabric, so the meaningful split is how the computation is laid out:

    - ``Auto``: let each driver pick.
    - ``XLA``: whole-matrix library call (``torch.linalg.cholesky_ex`` in the port; the
      name is kept for API parity) — the analogue of a single fused vendor call.
    - ``Tiled``: our blocked/tiled driver loop (the analogue of the task-DAG drivers);
      required for distributed execution and the path that honors nb/lookahead options.
    """

    Auto = "auto"
    XLA = "xla"
    Tiled = "tiled"
    # accepted aliases for reference CLI parity (`--target t/d` etc.)


Target._shorthand = {"t": Target.Tiled, "d": Target.Tiled, "h": Target.XLA,
                     "x": Target.XLA, "a": Target.Auto}


class TileKind(_StrEnum):
    """Tile provenance (Tile.hh:97-101). Informational (buffers are whole tensors)."""

    Workspace = "workspace"
    SlateOwned = "slateowned"
    UserOwned = "userowned"


class GridOrder(_StrEnum):
    """Process-grid ordering (enums.hh GridOrder; func.hh:178-217)."""

    Col = "col"
    Row = "row"
    Unknown = "unknown"


# ---------------------------------------------------------------------------
# Method enums — algorithmic variant selectors (enums.hh:108-455)
# ---------------------------------------------------------------------------


class MethodGemm(_StrEnum):
    """Stationary-matrix choice for gemm (enums.hh:108-114; src/gemm.cc:12-24)."""

    Auto = "auto"
    A = "a"          # stationary A (gemmA)
    C = "c"          # stationary C (gemmC)
    SUMMA = "summa"  # TPU addition: explicit shard_map SUMMA pipeline


class MethodHemm(_StrEnum):
    Auto = "auto"
    A = "a"
    C = "c"


class MethodTrsm(_StrEnum):
    Auto = "auto"
    A = "a"
    B = "b"


class MethodLU(_StrEnum):
    """LU pivoting variant (enums.hh:302-309)."""

    Auto = "auto"
    PartialPiv = "partialpiv"
    CALU = "calu"        # tournament pivoting (getrf_tntpiv)
    NoPiv = "nopiv"
    RBT = "rbt"          # random butterfly transform + nopiv
    BEAM = "beam"


class MethodEig(_StrEnum):
    """Tridiagonal eigensolver (enums.hh MethodEig:359-365)."""

    Auto = "auto"
    QR = "qr"       # steqr — real implicit-shift QR iteration
    DC = "dc"       # stedc — divide & conquer (the Auto performance path)
    Bisection = "bisection"   # sterf_bisect values + stein vectors — the
                              # reference marks this "not yet implemented"
                              # (enums.hh:363); implemented here
    MRRR = "mrrr"   # unimplemented in the reference too; routes to DC


class MethodSVD(_StrEnum):
    Auto = "auto"
    QR = "qr"         # bdsqr-style (auto: bisect values / dense vectors)
    DC = "dc"         # divide-and-conquer-class dense solve (gesdd/QDWH)
    Bisection = "bisection"   # GK bisection values + stein vectors —
                              # unimplemented in the reference, implemented
                              # here (linalg/svd.py bdsqr method='bisect')


class MethodCholQR(_StrEnum):
    """Inner product method for CholQR (enums.hh MethodCholQR)."""

    Auto = "auto"
    GemmA = "gemma"
    GemmC = "gemmc"
    HerkA = "herka"
    HerkC = "herkc"


class MethodGels(_StrEnum):
    """Least-squares factorization choice (enums.hh MethodGels)."""

    Auto = "auto"
    QR = "qr"
    CholQR = "cholqr"


# ---------------------------------------------------------------------------
# Options
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Options:
    """Per-call options (types.hh:32-81; option keys enums.hh:461-498).

    All drivers accept ``opts: Options | dict | None``. Unknown dict keys raise, like the
    reference's typed ``get_option<Option::X>`` (types.hh:240-271).
    """

    lookahead: int = 1
    block_size: int = 256           # Option::BlockSize (nb)
    inner_blocking: int = 256       # Option::InnerBlocking (ib); 256 keeps the
                                    # CALU tournament panels MXU/lane-aligned
                                    # (the reference's CPU default is far
                                    # smaller; tournament merge flops scale as
                                    # ib^2 so this is the TPU sweet spot).
                                    # NOTE: at the default block_size (256) the
                                    # two-level CALU split degenerates to a
                                    # single-level panel (ib == nb by design —
                                    # two levels only pay off at large nb); the
                                    # inner level engages when callers raise nb
                                    # (bench.py's getrf runs nb=2048, ib=256)
    max_panel_threads: int = 1      # kept for parity; no host thread teams on TPU
    tolerance: Optional[float] = None  # Option::Tolerance (mixed-precision IR)
    max_iterations: int = 30        # Option::MaxIterations (IR)
    use_fallback_solver: bool = True  # Option::UseFallbackSolver (gesv_mixed.cc:93-96)
    pivot_threshold: float = 1.0    # Option::PivotThreshold
    depth: int = 2                  # Option::Depth (RBT butterfly depth, gesv_rbt.cc)
    target: Target = Target.Auto
    trsm_via_inverse: bool = False  # tiled potrf panel: apply Lkk^{-1} as a
                                    # gemm instead of TriangularSolve (pure
                                    # MXU throughput for ~cond(Lkk)^2 local
                                    # error; bench sweep knob, linalg/chol.py)
    hold_local_workspace: bool = False  # parity only
    lu_panel: str = "tournament"    # CALU pivot-selection scheme: "tournament"
                                    # (binary merge tree of batched LUs,
                                    # getrf_tntpiv.cc) or "pp" (one partial-
                                    # pivot LU of the ib-wide subpanel selects
                                    # the pivot rows — ~6x fewer sequential
                                    # elimination steps per panel on TPU, where
                                    # each tournament level is a column-
                                    # sequential batched LU; A/B knob for the
                                    # getrf bench)
    print_verbose: int = 0          # Option::PrintVerbose (enums.hh:477-488)
    print_edgeitems: int = 16
    print_width: int = 10
    print_precision: int = 4
    # method selectors
    method_gemm: MethodGemm = MethodGemm.Auto
    method_hemm: MethodHemm = MethodHemm.Auto
    method_trsm: MethodTrsm = MethodTrsm.Auto
    method_lu: MethodLU = MethodLU.Auto
    method_eig: MethodEig = MethodEig.Auto
    method_svd: MethodSVD = MethodSVD.Auto
    method_cholqr: MethodCholQR = MethodCholQR.Auto
    method_gels: MethodGels = MethodGels.Auto
    # TPU-specific knobs (no reference analogue)
    precision: Optional[Any] = None   # compute dtype override (e.g. torch.bfloat16)
    factor_precision: Optional[Any] = None  # low precision for *_mixed factor step
    exact_info: bool = False          # host-refine LAPACK info indices (syncs!)
    # resilience knobs (slate_tpu.robust; no reference analogue — the
    # reference's UseFallbackSolver is the only health option it exposes)
    solve_report: bool = False        # append a robust.SolveReport to solver
                                      # returns (opt-in structured health)
    max_retries: int = 0              # host-level same-rung retries before a
                                      # ladder escalates (robust.RetryPolicy)
    retry_backoff: float = 0.0        # seconds between host-level retries
    f64_emulation: bool = False       # gemm via exact Ozaki bf16 splitting —
                                      # true double-precision results on f64-
                                      # less TPUs at ~s(s+1)/2 bf16-gemm cost
                                      # (ops/f64emu.py; SURVEY §7 hard-part 6)

    def replace(self, **kw) -> "Options":
        kw = {k: _coerce_option(k, v) for k, v in kw.items()}
        return dataclasses.replace(self, **kw)

    def cache_key(self) -> "tuple":
        """Canonical, hashable identity of this option set — the Options leg
        of the serving layer's compiled-executable cache key
        (slate_tpu.serve.cache; BLASX keys its software cache the same way:
        routine + shape + the knobs that change the generated code).

        Two option sets that would trace to the same program map to the same
        key: enums collapse to their string values, dtype-likes (``precision``
        / ``factor_precision`` accept ``torch.float32``, ``np.dtype``, or the
        string name) collapse to the canonical dtype name, and defaulted
        fields equal explicitly-passed identical values.  Fields are emitted
        in declaration order as ``(name, str)`` pairs, so the key is stable
        across processes (no ``hash()`` randomization, no object ids)."""
        parts = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            parts.append((f.name, _canon_option_value(v)))
        return tuple(parts)

    @classmethod
    def make(cls, opts: "Options | Dict[str, Any] | None") -> "Options":
        if opts is None:
            return cls()
        if isinstance(opts, Options):
            return opts
        if isinstance(opts, dict):
            return cls().replace(**opts)
        raise TypeError(f"opts must be Options, dict, or None, got {type(opts)}")


_ENUM_FIELDS = {
    "target": Target,
    "method_gemm": MethodGemm,
    "method_hemm": MethodHemm,
    "method_trsm": MethodTrsm,
    "method_lu": MethodLU,
    "method_eig": MethodEig,
    "method_svd": MethodSVD,
    "method_cholqr": MethodCholQR,
    "method_gels": MethodGels,
}


def _coerce_option(key: str, value: Any) -> Any:
    cls = _ENUM_FIELDS.get(key)
    if cls is not None and not isinstance(value, cls):
        return cls.from_string(value)
    return value


def _canon_option_value(v: Any) -> str:
    """One field value -> canonical string (see Options.cache_key)."""
    if v is None:
        return ""
    if isinstance(v, _StrEnum):
        return str(v)
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, (int, float, str)) and not isinstance(v, bool):
        # "float32" the string should canonicalize like the dtype it names
        if isinstance(v, str):
            try:
                import numpy as _np
                return _np.dtype(v).name
            except TypeError:
                return v
        return repr(v)
    # dtype-likes: torch.float32, np.dtype, np.float32, ...
    import torch
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    try:
        import numpy as _np
        return _np.dtype(v).name
    except TypeError:
        return str(v)
