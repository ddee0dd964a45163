"""Runtime types the port's engine needs (request cancellation context)."""

from .engine import Context

__all__ = ["Context"]
