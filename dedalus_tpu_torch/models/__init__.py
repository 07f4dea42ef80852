"""Model problems built on the public API."""

from .rbc import build_rbc_problem
