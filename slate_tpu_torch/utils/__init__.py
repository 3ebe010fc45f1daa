"""Support subsystems: tracing, debug, printing, checkpointing (reference §2.7)."""

from . import trace
from . import debug
from .checkpoint import load_matrix, save_matrix
from .printing import print_matrix
