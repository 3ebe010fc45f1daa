"""Finding model for slate-lint (the AST tier's output currency), the JAX
package's as it is.

A :class:`Finding` is one rule violation at one source location.  Its
:meth:`~Finding.fingerprint` deliberately excludes the line *number*: the
committed baseline (``analysis/baseline.json``) must keep matching a finding
when unrelated edits shift the file, so identity is
``(rule, path, context, line_text)`` — the enclosing ``def``/``class``
qualname plus the stripped source line.  Two identical lines in the same
function are the one case this collapses; the linter disambiguates by
allowing a baseline entry to absorb several occurrences only when
``count`` says so.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

#: severity ladder — ``error`` findings are CI-blocking when unbaselined;
#: ``warning`` findings also fail ``--check`` (one gate, no second-class
#: rules) but are rendered distinctly so humans triage errors first
SEVERITIES = ("error", "warning")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one source location."""

    rule: str          #: rule ID, e.g. ``SLT501``
    severity: str      #: ``error`` | ``warning``
    path: str          #: repo-relative posix path
    line: int          #: 1-based line of the offending node
    col: int           #: 0-based column of the offending node
    message: str       #: human sentence: what is wrong here
    context: str       #: enclosing qualname (``mod.fn.inner``) or ``<module>``
    line_text: str     #: stripped source line (fingerprint component)
    suggestion: str = ""   #: autofix hint (``--explain`` renders it)

    def fingerprint(self) -> Tuple[str, str, str, str]:
        """Baseline identity — line-number-free (module docstring)."""
        return (self.rule, self.path, self.context, self.line_text)

    def render(self, baselined: bool = False) -> str:
        tag = " [baselined]" if baselined else ""
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"{self.severity}: {self.message}{tag}")
