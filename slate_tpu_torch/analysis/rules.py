"""slate-lint rule set: the JAX package's rule IDs and severities, each with
the subject it has in torch code.

Each rule is a checker registered in :data:`RULES` with an ID, severity, and
one-line title.  Checkers receive a ``ModuleCtx`` (see ``lint.py``) exposing
the parsed tree, parent links, qualnames, and a ``finding()`` factory; they
yield :class:`~slate_tpu_torch.analysis.findings.Finding` objects.

In the JAX package the SLT1xx rules guard traced values inside jitted cores.
The torch hazard in the same place is a host sync: a branch on a tensor,
``.item()``, ``.cpu()`` and the like wait for the card.  The port's sync-free
cores are named in :data:`SYNC_FREE_CORES` (the functions ``chip_smoke.py``
runs under ``torch.cuda.set_sync_debug_mode("error")``), so the SLT1xx rules
read those functions' tensor parameters.  SLT201 reads a kernel build or a
``torch.compile`` in a loop, SLT202 a mutable default where the arguments
enter a cache key, SLT301 a process-global precision toggle, SLT302 a debug
hook, SLT401 an ``out=`` tensor that is also an input; SLT203, SLT501 and
SLT601 are the JAX package's.

Suppression: any rule can be silenced at one site with a trailing or
preceding comment ``# slate-lint: disable=SLT501 -- reason`` (the reason is
mandatory by convention and checked in review, not by the parser).  Accepted
pre-existing findings live in ``analysis/baseline.json`` instead.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Callable, Dict, Iterator, List, Set, Tuple

from .findings import Finding

# ---------------------------------------------------------------------------
# registry


@dataclasses.dataclass(frozen=True)
class Rule:
    """One registered lint rule."""

    id: str
    severity: str
    title: str
    doc: str
    checker: Callable


RULES: Dict[str, Rule] = {}


def rule(rule_id: str, severity: str, title: str):
    """Register a checker under ``rule_id`` (decorator)."""
    def deco(fn):
        RULES[rule_id] = Rule(rule_id, severity, title,
                              (fn.__doc__ or "").strip(), fn)
        return fn
    return deco


# ---------------------------------------------------------------------------
# shared AST helpers

#: the port's sync-free cores (dotted name -> host parameters, the ones that
#: are not tensors): the batched launch half and the cores it runs, which
#: ``chip_smoke.py`` holds under ``torch.cuda.set_sync_debug_mode("error")``
SYNC_FREE_CORES: Dict[str, Tuple[str, ...]] = {
    "slate_tpu_torch.serve.batched.start_batched":
        ("routine", "opts", "cache", "donate", "n_real", "device"),
    "slate_tpu_torch.linalg.lu.gesv_core": (),
    "slate_tpu_torch.linalg.chol.posv_core": (),
    "slate_tpu_torch.linalg.qr.gels_core": (),
}

#: attribute reads on a tensor that are metadata — Python control flow on
#: these waits for nothing
STATIC_SAFE_ATTRS = frozenset({"shape", "ndim", "dtype", "size", "device",
                               "is_cuda", "is_complex", "is_floating_point",
                               "numel", "dim", "layout", "itemsize",
                               "element_size", "requires_grad"})

#: calls that copy a tensor to the host (and so wait for the card)
_HOST_METHODS = ("item", "tolist", "cpu", "numpy")


def dotted(node: ast.AST) -> str:
    """``a.b.c`` for an Attribute/Name chain, else ''."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _param_names(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


@dataclasses.dataclass
class TracedCore:
    """A function of :data:`SYNC_FREE_CORES` found in the module (the JAX
    package's name: there a jitted core, here a sync-free one)."""

    fn: ast.AST                    # FunctionDef / AsyncFunctionDef
    how: str                       # "sync-free core"
    static: Set[str]               # host parameters (not tensors)


def traced_cores(ctx) -> List[TracedCore]:
    """The module's functions named in :data:`SYNC_FREE_CORES` (``ctx`` is
    the ``lint.ModuleCtx``: the table is keyed by dotted name)."""
    out = []
    for node in ast.walk(ctx.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            host = SYNC_FREE_CORES.get(f"{ctx.module}.{ctx.qualname(node)}")
            if host is not None:
                out.append(TracedCore(node, "sync-free core", set(host)))
    return out


def _tensor_param_uses(core: TracedCore, scope: ast.AST, ctx
                       ) -> Iterator[ast.Name]:
    """Bare loads of a core's tensor params within ``scope`` that are not in
    a metadata position (``x.shape``, ``x is None``, ``len(x)``,
    ``isinstance(x, ...)``)."""
    tensors = set(_param_names(core.fn)) - core.static
    for n in ast.walk(scope):
        if not (isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
                and n.id in tensors):
            continue
        parent = ctx.parent(n)
        if isinstance(parent, ast.Attribute) \
                and parent.attr in STATIC_SAFE_ATTRS:
            continue
        if isinstance(parent, ast.Call) and parent.func is n:
            continue                       # the name is being *called*
        if isinstance(parent, ast.Call) \
                and dotted(parent.func) in ("len", "isinstance", "type",
                                            "repr", "str"):
            continue
        if isinstance(parent, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops):
            continue                       # `x is None` identity checks
        yield n


# ---------------------------------------------------------------------------
# host syncs in the sync-free cores


@rule("SLT101", "error", "Python control flow on a tensor in a sync-free core")
def _tensor_branch(ctx):
    """`if`/`while`/`assert`/ternary on a sync-free core's tensor parameter
    converts the tensor to a Python bool: a host sync that waits for the
    card, which the core promises never to do.  Use `torch.where` or keep
    the test on metadata (`.shape`, `.dtype`)."""
    for core in ctx.cores:
        for node in ast.walk(core.fn):
            tests = []
            if isinstance(node, (ast.If, ast.While, ast.IfExp, ast.Assert)):
                tests.append(node.test)
            for test in tests:
                for use in _tensor_param_uses(core, test, ctx):
                    yield ctx.finding(
                        "SLT101", use,
                        f"Python control flow on tensor {use.id!r} inside "
                        f"sync-free core {core.fn.name!r} (a host sync)",
                        suggestion="use torch.where, or branch on metadata "
                                   "(.shape/.dtype) only")
                    break                  # one finding per test expression


@rule("SLT102", "error", "host copy of a tensor in a sync-free core")
def _host_materialize(ctx):
    """`float()`/`int()`/`bool()`/`complex()`, `.item()`, `.tolist()`,
    `.cpu()` or `.numpy()` on a sync-free core's tensor copies it to the host
    and waits for the card (`set_sync_debug_mode("error")` raises there)."""
    for core in ctx.cores:
        tensors = set(_param_names(core.fn)) - core.static
        for node in ast.walk(core.fn):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            hit = None
            if fname in ("float", "int", "bool", "complex"):
                for a in node.args:
                    if isinstance(a, ast.Name) and a.id in tensors:
                        hit = f"{fname}({a.id})"
                        break
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in _HOST_METHODS:
                names = {n.id for n in ast.walk(node.func.value)
                         if isinstance(n, ast.Name)}
                if names & tensors:
                    hit = f".{node.func.attr}() on " \
                          f"{sorted(names & tensors)[0]!r}"
            if hit:
                yield ctx.finding(
                    "SLT102", node,
                    f"host copy {hit} of a tensor inside sync-free core "
                    f"{core.fn.name!r}",
                    suggestion="keep the value on the device (torch ops), or "
                               "move the read into the resolve half")


@rule("SLT103", "error", "numpy call on a tensor in a sync-free core")
def _numpy_in_core(ctx):
    """`np.*` on a sync-free core's tensor copies it to the host (and waits
    for the card) or fails on a CUDA tensor.  Use the `torch` equivalent."""
    for core in ctx.cores:
        tensors = set(_param_names(core.fn)) - core.static
        for node in ast.walk(core.fn):
            if not isinstance(node, ast.Call):
                continue
            fname = dotted(node.func)
            if not (fname.startswith("np.") or fname.startswith("numpy.")):
                continue
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(a, ast.Name) and a.id in tensors:
                    yield ctx.finding(
                        "SLT103", node,
                        f"numpy call {fname}() on tensor {a.id!r} inside "
                        f"sync-free core {core.fn.name!r}",
                        suggestion=f"use torch.{fname.split('.', 1)[1]} (or "
                                   "hoist the numpy work out of the core)")
                    break


# ---------------------------------------------------------------------------
# rebuild / cache-key hazards

#: calls that compile or build a kernel
_BUILDERS = ("torch.compile", "torch.utils.cpp_extension.load",
             "torch.utils.cpp_extension.load_inline", "cpp_extension.load",
             "cpp_extension.load_inline", "cuda_norms.build", "cn.build")

#: functions whose arguments enter a cache key besides the lru_cache'd ones
#: (the serving cache's key and lookups)
CACHE_KEY_FUNCS = ("slate_tpu_torch.serve.cache.ExecutableCache.make_key",
                   "slate_tpu_torch.serve.cache.ExecutableCache.get",
                   "slate_tpu_torch.serve.cache.ExecutableCache.warmup")


@rule("SLT201", "warning", "kernel build or torch.compile inside a loop")
def _build_in_loop(ctx):
    """`torch.compile(...)`, `torch.utils.cpp_extension.load(...)` or
    `cuda_norms.build(...)` inside a `for`/`while` body builds (or looks up)
    a compiled program every iteration; closure-captured values defeat
    torch.compile's cache entirely.  Hoist the build out of the loop."""
    seen = set()                  # nested loops reach the same Call twice
    for node in ast.walk(ctx.tree):
        if not isinstance(node, (ast.For, ast.While, ast.AsyncFor)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call) and dotted(sub.func) in _BUILDERS \
                    and id(sub) not in seen:
                seen.add(id(sub))
                yield ctx.finding(
                    "SLT201", sub,
                    f"{dotted(sub.func)} inside a loop body (a build or "
                    "compile every iteration)",
                    suggestion="hoist the build out of the loop or memoize "
                               "it with functools.lru_cache")


def _keys_cache(fn: ast.AST, ctx) -> bool:
    for dec in fn.decorator_list:
        base = dec.func if isinstance(dec, ast.Call) else dec
        if dotted(base).rsplit(".", 1)[-1] in ("lru_cache", "cache"):
            return True
    return f"{ctx.module}.{ctx.qualname(fn)}" in CACHE_KEY_FUNCS


@rule("SLT202", "error", "mutable default on a function whose arguments key a cache")
def _unhashable_static(ctx):
    """A parameter of an `lru_cache`d function, or of the serving cache's
    key and lookups (:data:`CACHE_KEY_FUNCS`), that defaults to a
    list/dict/set literal: the default raises `TypeError: unhashable type`
    in the cache, or, held as a shared mutable object, keys the cache on
    state that later calls change."""
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                or not _keys_cache(fn, ctx):
            continue
        a = fn.args
        params = a.posonlyargs + a.args
        defaults = [None] * (len(params) - len(a.defaults)) + list(a.defaults)
        pairs = list(zip(params, defaults)) + \
            list(zip(a.kwonlyargs, a.kw_defaults))
        for p, d in pairs:
            if isinstance(d, (ast.List, ast.Dict, ast.Set)):
                yield ctx.finding(
                    "SLT202", d,
                    f"argument {p.arg!r} of cache-keyed function "
                    f"{fn.name!r} defaults to a mutable "
                    f"{type(d).__name__.lower()} literal",
                    suggestion="use a tuple/frozenset/None default")


@rule("SLT203", "warning", "Options used as a cache key without cache_key()")
def _options_key(ctx):
    """On serve paths, an `Options` instance folded into an executable-cache
    key without `.cache_key()` keys the cache on object identity — every
    request misses and recompiles.  `serve/cache.py` documents the canonical
    key shape."""
    if not ctx.relpath.startswith("slate_tpu_torch/serve/"):
        return
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted(node.func)
        if fname not in ("Options", "Options.make"):
            continue
        parent = ctx.parent(node)
        if isinstance(parent, ast.Attribute) and parent.attr == "cache_key":
            continue
        if isinstance(parent, (ast.Tuple, ast.Dict, ast.Subscript)):
            yield ctx.finding(
                "SLT203", node,
                f"{fname}(...) folded into a key structure without "
                ".cache_key() — identity-keyed cache, every request misses",
                suggestion="call .cache_key() on the Options before keying")


# ---------------------------------------------------------------------------
# precision + debug hygiene

#: files allowed to set process-global precision (the tester entrypoint owns
#: its process)
PRECISION_ALLOWED = ("slate_tpu_torch/testing/__main__.py",)
X64_ALLOWED = PRECISION_ALLOWED      # the JAX package's name for the list


def _literal(node: ast.AST):
    return node.value if isinstance(node, ast.Constant) else None


@rule("SLT301", "error", "process-global precision toggle outside the entrypoint")
def _global_precision(ctx):
    """`torch.set_default_dtype(...)`, `torch.backends.cuda.matmul.allow_tf32
    = True` (or cudnn's) and `torch.set_float32_matmul_precision(...)` to
    anything but "highest" change float precision for the whole process and
    leak across sweep rows and library callers; TF32 stays off on every
    parity path.  Only the tester entrypoint may set them."""
    if ctx.relpath in PRECISION_ALLOWED:
        return
    for node in ast.walk(ctx.tree):
        hit = None
        if isinstance(node, ast.Call):
            fname = dotted(node.func)
            if fname.endswith("set_default_dtype"):
                hit = f"{fname}()"
            elif fname.endswith("set_float32_matmul_precision") and not (
                    node.args and _literal(node.args[0]) == "highest"):
                hit = f"{fname}() to a precision other than 'highest'"
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if dotted(t).endswith("allow_tf32") \
                        and _literal(node.value) is not False:
                    hit = f"{dotted(t)} = {ast.unparse(node.value)}"
        if hit:
            yield ctx.finding(
                "SLT301", node,
                f"process-global precision toggle {hit} outside the tester "
                "entrypoint (leaks across sweep rows and callers)",
                suggestion="keep the float32 matmul precision 'highest' and "
                           "TF32 off, or scope the change and restore it")


@rule("SLT302", "warning", "leftover debug hook")
def _debug_left(ctx):
    """`breakpoint()`/`pdb.set_trace()`/`torch.autograd.set_detect_anomaly`/
    `torch.cuda.set_sync_debug_mode` left in package code: breakpoints hang
    non-interactive runs (CI, serving), and the two torch switches slow or
    fail every later call of the process."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        fname = dotted(node.func)
        if fname in ("pdb.set_trace", "breakpoint") \
                or fname.endswith("autograd.set_detect_anomaly") \
                or fname.endswith("cuda.set_sync_debug_mode"):
            yield ctx.finding(
                "SLT302", node,
                f"leftover debug hook {fname}()",
                suggestion="remove it (or route through utils/debug.py, "
                           "which gates on an env switch)")


# ---------------------------------------------------------------------------
# aliasing (the torch form of donation misuse)


@rule("SLT401", "error", "out= tensor is also an input of the same call")
def _out_aliases_input(ctx):
    """A call whose `out=` tensor is also one of its inputs: the op writes
    the result over an operand it is still reading (torch refuses some such
    calls and silently computes garbage for others) — the nearest torch
    form of donating a buffer the program still reads.  The check is sound
    for a plain name passed twice; aliasing through views is not seen."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        out = next((kw.value for kw in node.keywords if kw.arg == "out"), None)
        if not isinstance(out, ast.Name):
            continue
        inputs = list(node.args) + [kw.value for kw in node.keywords
                                    if kw.arg not in ("out", None)]
        if any(isinstance(a, ast.Name) and a.id == out.id for a in inputs):
            yield ctx.finding(
                "SLT401", node,
                f"out={out.id} is also an input of {dotted(node.func) or 'the call'}",
                suggestion="write to a fresh tensor, or use the op's in-place "
                           "form where it is defined")


# ---------------------------------------------------------------------------
# exception taxonomy


@rule("SLT501", "error", "broad except can swallow the NumericalError taxonomy")
def _broad_except(ctx):
    """`except Exception:` / bare `except:` without a re-raise swallows
    `NumericalError`/`SingularMatrixError`/`ConvergenceError`, turning a
    diagnosable numerical failure into silent fallback behavior.  Narrow the
    handler, re-raise the taxonomy first, or mark the swallow intentional
    with `# slate-lint: disable=SLT501 -- reason`."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = node.type is None
        if isinstance(node.type, ast.Name) \
                and node.type.id in ("Exception", "BaseException"):
            broad = True
        if isinstance(node.type, ast.Tuple) and any(
                isinstance(e, ast.Name)
                and e.id in ("Exception", "BaseException")
                for e in node.type.elts):
            broad = True
        if not broad:
            continue
        if any(isinstance(sub, ast.Raise) for sub in ast.walk(node)):
            continue                       # handler re-raises — not a swallow
        yield ctx.finding(
            "SLT501", node,
            "broad except without re-raise can swallow "
            "NumericalError/SingularMatrixError/ConvergenceError",
            suggestion="narrow the exception type, add `except "
                       "NumericalError: raise` above it, or suppress with "
                       "`# slate-lint: disable=SLT501 -- reason`")


# ---------------------------------------------------------------------------
# observability coverage

#: module-level function suffixes that mark a public distributed driver
_DRIVER_SUFFIXES = ("_distributed", "_pipelined", "_sharded")


@rule("SLT601", "warning", "public distributed driver missing @obs.instrument")
def _missing_instrument(ctx):
    """Every public driver in `slate_tpu_torch/parallel` wears `@instrument`
    so the span and metrics coverage stays complete (the runtime meta-test,
    enforced statically with an autofix suggestion)."""
    if not ctx.relpath.startswith("slate_tpu_torch/parallel/"):
        return
    for node in ctx.tree.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if node.name.startswith("_") \
                or not node.name.endswith(_DRIVER_SUFFIXES):
            continue
        has = False
        for dec in node.decorator_list:
            base = dec.func if isinstance(dec, ast.Call) else dec
            if dotted(base).rsplit(".", 1)[-1] == "instrument":
                has = True
        if not has:
            yield ctx.finding(
                "SLT601", node,
                f"public distributed driver {node.name!r} is not "
                "@instrument-ed (invisible to spans/SCALING coverage)",
                suggestion="add `@instrument` (from ..obs import instrument) "
                           "above the def")


def rule_table() -> List[Tuple[str, str, str]]:
    """(id, severity, title) rows, sorted — the README/--rules table."""
    return [(r.id, r.severity, r.title)
            for r in sorted(RULES.values(), key=lambda r: r.id)]
