"""slate-lint driver: parse package sources, run the rule set, apply
suppressions and the committed baseline.

The AST tier is pure-stdlib work over source text: this module imports no
torch, so linting stays fast (the package ``__init__`` still loads torch on
import).
"""

from __future__ import annotations

import ast
import io
import os
import re
import tokenize
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .findings import Finding
from .rules import RULES

#: inline suppression: ``# slate-lint: disable=SLT501 -- reason`` on the
#: finding's line or the line directly above it
_SUPPRESS_RE = re.compile(
    r"#\s*slate-lint:\s*disable=([A-Z0-9, ]+?)(?:\s*--\s*(.*))?\s*$")


class ModuleCtx:
    """One parsed source module handed to every rule checker."""

    def __init__(self, path: str, relpath: str, text: str):
        self.path = path
        self.relpath = relpath
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self._parents: Dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self._parents[child] = parent
        from .rules import traced_cores
        self.module = module_name(relpath)
        self.cores = traced_cores(self)
        self.suppressions = self._parse_suppressions()

    # -- structure ----------------------------------------------------------
    def parent(self, node: ast.AST) -> Optional[ast.AST]:
        return self._parents.get(node)

    def qualname(self, node: ast.AST) -> str:
        """Enclosing def/class chain of ``node`` (``outer.inner``), or
        ``<module>``."""
        parts: List[str] = []
        cur = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                parts.append(cur.name)
            cur = self._parents.get(cur)
        return ".".join(reversed(parts)) or "<module>"

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    # -- findings -----------------------------------------------------------
    def finding(self, rule_id: str, node: ast.AST, message: str,
                suggestion: str = "") -> Finding:
        rule = RULES[rule_id]
        line = getattr(node, "lineno", 1)
        return Finding(rule=rule_id, severity=rule.severity,
                       path=self.relpath, line=line,
                       col=getattr(node, "col_offset", 0), message=message,
                       context=self.qualname(node),
                       line_text=self.line_text(line),
                       suggestion=suggestion)

    # -- suppressions -------------------------------------------------------
    def _parse_suppressions(self) -> Dict[int, Set[str]]:
        # tokenize, not a raw line scan: the directive must sit in a real
        # comment — a string literal or docstring that merely *mentions*
        # "# slate-lint: disable=..." (rule docs, fix-suggestion text,
        # jax.debug.print payloads) must not suppress anything.  ast.parse
        # already succeeded in __init__, so tokenization cannot fail.
        out: Dict[int, Set[str]] = {}
        for tok in tokenize.generate_tokens(io.StringIO(self.text).readline):
            if tok.type != tokenize.COMMENT:
                continue
            m = _SUPPRESS_RE.search(tok.string)
            if not m:
                continue
            ids = {t.strip() for t in m.group(1).split(",") if t.strip()}
            out.setdefault(tok.start[0], set()).update(ids)
        return out

    def suppressed(self, f: Finding) -> bool:
        if f.rule in self.suppressions.get(f.line, ()):
            return True
        # look upward through the contiguous comment block above the finding
        # (a disable= line may carry a multi-line justification under it)
        ln = f.line - 1
        while ln >= 1 and self.line_text(ln).startswith("#"):
            if f.rule in self.suppressions.get(ln, ()):
                return True
            ln -= 1
        return False


def module_name(relpath: str) -> str:
    """Dotted module name of a repo-relative path
    (``slate_tpu_torch/linalg/lu.py`` -> ``slate_tpu_torch.linalg.lu``)."""
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("/", ".")
    return mod[:-len(".__init__")] if mod.endswith(".__init__") else mod


def package_root() -> str:
    """The ``slate_tpu_torch`` package directory this module ships in."""
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def repo_root() -> str:
    return os.path.dirname(package_root())


def iter_source_files(root: Optional[str] = None) -> Iterable[str]:
    """Every ``.py`` file under the package, sorted for stable output."""
    root = root or package_root()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)


def _syntax_finding(relpath: str, e: SyntaxError) -> Finding:
    """The synthetic SLT000 finding every entry point returns for
    unparseable input."""
    return Finding(rule="SLT000", severity="error", path=relpath,
                   line=e.lineno or 1, col=e.offset or 0,
                   message=f"syntax error: {e.msg}", context="<module>",
                   line_text="")


def _run_rules(ctx: ModuleCtx,
               rules: Optional[Sequence[str]]) -> List[Finding]:
    """Apply the (optionally filtered) rule set to one parsed module,
    dropping suppressed findings — the one body shared by every lint
    entry point so filtering/suppression/sort order can't diverge."""
    out: List[Finding] = []
    for rule_id, rule in sorted(RULES.items()):
        if rules is not None and rule_id not in rules:
            continue
        for f in rule.checker(ctx) or ():
            if not ctx.suppressed(f):
                out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return out


def lint_file(path: str, rel_root: Optional[str] = None,
              rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run the rule set over one file; suppressed findings are dropped."""
    rel_root = rel_root or repo_root()
    relpath = os.path.relpath(os.path.abspath(path), rel_root)
    relpath = relpath.replace(os.sep, "/")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    try:
        ctx = ModuleCtx(path, relpath, text)
    except SyntaxError as e:
        return [_syntax_finding(relpath, e)]
    return _run_rules(ctx, rules)


def lint_package(root: Optional[str] = None,
                 rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every source file in the package (the repo gate's input)."""
    root = root or package_root()
    rel_root = repo_root() if root == package_root() \
        else _rel_root_for(root)
    out: List[Finding] = []
    for path in iter_source_files(root):
        out.extend(lint_file(path, rel_root=rel_root, rules=rules))
    return out


def lint_source(text: str, relpath: str = "snippet.py",
                rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint a source string (fixture tests; editor integrations).

    ``relpath`` participates in path-scoped rules — pass e.g.
    ``slate_tpu_torch/serve/x.py`` to exercise the serve-path rules, or a
    sync-free core's own module path to exercise the host-sync rules.  Unparseable
    input yields the same synthetic SLT000 finding as :func:`lint_file`
    (editors routinely lint in-progress buffers; they get a finding, not a
    traceback)."""
    try:
        ctx = ModuleCtx(relpath, relpath, text)
    except SyntaxError as e:
        return [_syntax_finding(relpath, e)]
    return _run_rules(ctx, rules)


def _rel_root_for(path: str) -> str:
    """Directory relpaths are taken against: the parent of the *topmost*
    package directory containing ``path``, found by walking up while an
    ``__init__.py`` is present.  This keeps relpaths package-qualified
    (``slate_tpu_torch/parallel/pivot.py``, never ``parallel/pivot.py``) so
    the path-scoped rules (SLT101-103/SLT203/SLT301/SLT601) and baseline
    fingerprints
    behave identically to :func:`lint_package`."""
    d = os.path.abspath(path)
    if not os.path.isdir(d):
        d = os.path.dirname(d)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return d


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint an explicit mix of files and directories (CLI convenience)."""
    out: List[Finding] = []
    for p in paths:
        if os.path.isdir(p):
            for f in iter_source_files(p):
                out.extend(lint_file(f, rel_root=_rel_root_for(p),
                                     rules=rules))
        else:
            out.extend(lint_file(p, rel_root=_rel_root_for(p), rules=rules))
    return out
