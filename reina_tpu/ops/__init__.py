"""Vectorized primitives backing the engine."""

from .clamped import clamped_counter_grants  # noqa: F401
