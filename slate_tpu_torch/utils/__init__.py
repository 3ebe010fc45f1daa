"""Host-side utilities (tracing and phase timers)."""

from . import trace
