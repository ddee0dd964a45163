"""Standalone KV-router service: a routing endpoint any client can call for
a worker set it does not own (prefill pools, frontends that share one
routing brain). The port's copy of the reference package's router."""

from .service import RouterService

__all__ = ["RouterService"]
