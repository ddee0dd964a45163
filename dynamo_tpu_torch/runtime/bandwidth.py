"""Per-wire KV-transfer bandwidth estimation (the transfer-cost signal).

The port's copy of the reference package's runtime/bandwidth.py. One
process-wide EWMA of observed bytes/second per wire class, seeded with
static priors so that routing is sane before the first transfer lands,
and fed by ``KvTransferClient`` (engine/transfer.py) from the same
measurements its ``kv.transfer.pull`` spans record. The wire classes are
the reference's names: ``ici`` (the in-process card-to-card move, the
reference's same-slice device fabric), ``device`` (a pull between two
processes through the serving card's memory, CUDA IPC here), ``native``
(the C++ agent; not in the port yet) and ``inline`` (pages in the request
plane's frames).

Estimates are per wire class, not per peer: routing only needs to rank the
paths. ``transfer_seconds(wire, nbytes)`` is the scoring primitive the
PrefillRouter prices candidates with.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from . import metrics as M

# static priors (bytes/second), used until a wire class has observations.
# The two device classes move each byte once through the H100's HBM3
# (3.35e12 B/s read + write: half of it); the host classes keep the
# reference's host-path orders of magnitude (a raw-TCP memcpy loop, frames
# on the asyncio request plane). No prior is a TPU figure.
WIRE_PRIORS: Dict[str, float] = {
    "ici": 1.675e12,
    "device": 1.675e12,
    "native": 2.0e9,
    "inline": 5.0e8,
}
DEFAULT_WIRE = "inline"  # the pessimistic assumption for an unknown path
_DOC = "EWMA of observed KV transfer bandwidth per wire class"


class WireBandwidthEstimator:
    """EWMA of observed per-wire bandwidth, seeded with static priors.

    Thread-safe: observations arrive from transfer client coroutines and
    executor threads; reads come from routing hot paths. ``alpha`` weights
    the newest observation (0.3: a memory of about three transfers)."""

    def __init__(
        self,
        alpha: float = 0.3,
        priors: Optional[Dict[str, float]] = None,
        metrics: Optional[M.MetricsScope] = None,
    ):
        self.alpha = float(alpha)
        self.priors = dict(WIRE_PRIORS)
        if priors:
            self.priors.update(priors)
        self._ewma: Dict[str, float] = {}
        self._observations: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._gauge = None
        if metrics is not None:
            self.attach_metrics(metrics)

    def attach_metrics(self, metrics: M.MetricsScope) -> None:
        """Late-bind a metrics scope (the process singleton is created
        before any registry exists)."""
        self._gauge = metrics.gauge(M.KV_WIRE_BANDWIDTH, _DOC, extra_labels=("wire",))

    def observe(self, wire: str, nbytes: int, seconds: float) -> None:
        """Fold one completed transfer leg into the wire's estimate.
        Degenerate samples (zero bytes, a non-positive duration: a fully
        cached pull) are ignored."""
        if nbytes <= 0 or seconds <= 0:
            return
        bw = nbytes / seconds
        with self._lock:
            prev = self._ewma.get(wire)
            cur = bw if prev is None else prev + self.alpha * (bw - prev)
            self._ewma[wire] = cur
            self._observations[wire] = self._observations.get(wire, 0) + 1
        if self._gauge is not None:
            self._gauge.set(cur, wire=wire)

    def bandwidth(self, wire: str) -> float:
        """Bytes/second for a wire class: the EWMA when observed, else the
        static prior (unknown classes price as DEFAULT_WIRE)."""
        with self._lock:
            est = self._ewma.get(wire)
        if est is not None:
            return est
        return self.priors.get(wire, self.priors[DEFAULT_WIRE])

    def transfer_seconds(self, wire: str, nbytes: int) -> float:
        """Estimated seconds to move ``nbytes`` over ``wire``; 0 bytes is
        free whatever the wire."""
        if nbytes <= 0:
            return 0.0
        return nbytes / self.bandwidth(wire)

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        """{wire: {bandwidth_bytes_s, observations, prior_bytes_s}}, for
        ``/debug/worker`` and reports."""
        with self._lock:
            wires = set(self.priors) | set(self._ewma)
            return {
                w: {
                    "bandwidth_bytes_s": self._ewma.get(
                        w, self.priors.get(w, self.priors[DEFAULT_WIRE])),
                    "observations": self._observations.get(w, 0),
                    "prior_bytes_s": self.priors.get(w, self.priors[DEFAULT_WIRE]),
                }
                for w in sorted(wires)
            }


_estimator: Optional[WireBandwidthEstimator] = None
_estimator_lock = threading.Lock()


def get_bandwidth_estimator() -> WireBandwidthEstimator:
    """The process-wide estimator every transfer client feeds and every
    router reads (one process observes one network position)."""
    global _estimator
    if _estimator is None:
        with _estimator_lock:
            if _estimator is None:
                _estimator = WireBandwidthEstimator()
    return _estimator
