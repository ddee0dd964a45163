"""Hierarchical metrics with Prometheus text exposition, standard library only.

The port's counterpart of the reference package's runtime/metrics.py,
which builds on ``prometheus_client`` (absent on the machine the port
serves on). The names, labels and the ``MetricsScope`` / bound-metric API
are the reference's: each level of the component tree owns a scope that
stamps ``dtpu_namespace`` / ``dtpu_component`` / ``dtpu_endpoint`` labels
onto every metric created beneath it, all backed by one registry, and
``expose()`` renders the Prometheus text format (0.0.4) as
``prometheus_client.generate_latest`` does: the same sample names (a
counter's ``_total`` and ``_created``, a histogram's ``_bucket`` /
``_count`` / ``_sum`` / ``_created``), labels sorted by name, and Go-style
float formatting.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

PREFIX = "dtpu"

REQUESTS_TOTAL = f"{PREFIX}_requests_total"
REQUEST_DURATION_SECONDS = f"{PREFIX}_request_duration_seconds"
INFLIGHT_REQUESTS = f"{PREFIX}_inflight_requests"
TTFT_SECONDS = f"{PREFIX}_time_to_first_token_seconds"
ITL_SECONDS = f"{PREFIX}_inter_token_latency_seconds"
INPUT_TOKENS = f"{PREFIX}_input_tokens_total"
OUTPUT_TOKENS = f"{PREFIX}_output_tokens_total"
RETRY_ATTEMPTS_TOTAL = f"{PREFIX}_retry_attempts_total"
RETRY_GIVEUPS_TOTAL = f"{PREFIX}_retry_giveups_total"
CIRCUIT_STATE = f"{PREFIX}_circuit_state"
CIRCUIT_TRANSITIONS_TOTAL = f"{PREFIX}_circuit_transitions_total"
KV_HIT_TOKENS = f"{PREFIX}_kv_cached_tokens_total"
QUEUED_REQUESTS = f"{PREFIX}_queued_requests"
KV_ACTIVE_BLOCKS = f"{PREFIX}_kv_active_blocks"
KV_TOTAL_BLOCKS = f"{PREFIX}_kv_total_blocks"
KV_FREE_BLOCKS = f"{PREFIX}_kv_free_blocks"
WORKER_ACTIVE_DECODE_BLOCKS = f"{PREFIX}_worker_active_decode_blocks"
# engine step telemetry (engine/telemetry.py)
STEP_DURATION_SECONDS = f"{PREFIX}_engine_step_duration_seconds"
STEP_TOKENS = f"{PREFIX}_engine_tokens_per_step"
BATCH_OCCUPANCY = f"{PREFIX}_engine_batch_occupancy"
SPEC_ACCEPTANCE = f"{PREFIX}_engine_spec_acceptance_rate"
SLOW_STEPS_TOTAL = f"{PREFIX}_engine_slow_steps_total"
# SLO accounting (runtime/slo.py), attribution, health detectors
SLO_ATTAINMENT = f"{PREFIX}_slo_attainment_ratio"
SLO_BURN_RATE = f"{PREFIX}_slo_burn_rate"
GOODPUT_TOKENS = f"{PREFIX}_goodput_tokens_total"
REQUEST_PHASE_SECONDS = f"{PREFIX}_request_phase_seconds"
HEALTH_EVENTS_TOTAL = f"{PREFIX}_health_events_total"
# disaggregation (runtime/bandwidth.py, engine/transfer.py, llm/prefill_router.py)
KV_WIRE_BANDWIDTH = f"{PREFIX}_kv_wire_bandwidth_bytes_per_s"
KV_TRANSFER_FALLBACKS_TOTAL = f"{PREFIX}_kv_transfer_fallbacks_total"
GLOBAL_KV_HITS_TOTAL = f"{PREFIX}_global_kv_hits_total"
GLOBAL_KV_DIRECTORY_ENTRIES = f"{PREFIX}_global_kv_directory_entries"
GLOBAL_KV_DEDUP_BLOCKS_TOTAL = f"{PREFIX}_global_kv_dedup_blocks_total"
PREFILL_DEFLECTED_TOTAL = f"{PREFIX}_prefill_deflected_total"
# planned reclaims (engine/drain.py, engine/checkpoint.py)
DRAIN_EVACUATED_BLOCKS = f"{PREFIX}_drain_evacuated_blocks_total"
DRAIN_DEADLINE_MARGIN = f"{PREFIX}_drain_deadline_margin_seconds"
CHECKPOINT_RESTORE_MODE = f"{PREFIX}_checkpoint_restore_mode"

LABEL_NAMESPACE = "dtpu_namespace"
LABEL_COMPONENT = "dtpu_component"
LABEL_ENDPOINT = "dtpu_endpoint"
LABEL_MODEL = "model"
LABEL_SLA_CLASS = "sla_class"
LABEL_WINDOW = "window"

# prometheus_client's default histogram buckets
DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.075, 0.1, 0.25, 0.5, 0.75, 1.0, 2.5,
                   5.0, 7.5, 10.0)


def go_float(d: float) -> str:
    """A float as Go (and prometheus_client) print it in the text format."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if d != d:
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape(v: str) -> str:
    return v.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labels(pairs: Iterable[Tuple[str, str]]) -> str:
    items = sorted(pairs)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in items) + "}"


class _Metric:
    """One metric family: its children by label values, under a lock."""

    kind = ""

    def __init__(self, name: str, doc: str, labelnames: Tuple[str, ...]):
        self.name = name
        self.doc = doc
        self.labelnames = labelnames
        self._children: Dict[Tuple[str, ...], list] = {}
        self._lock = threading.Lock()

    def _child(self, values: Tuple[str, ...]) -> list:
        child = self._children.get(values)
        if child is None:
            child = self._children[values] = self._new()
        return child

    def _new(self) -> list:
        return [0.0, time.time()]

    def _header(self, name: str, kind: str) -> List[str]:
        doc = self.doc.replace("\\", r"\\").replace("\n", r"\n")
        return [f"# HELP {name} {doc}", f"# TYPE {name} {kind}"]

    def _created(self, base: str) -> List[str]:
        lines = self._header(f"{base}_created", "gauge")
        for values, child in list(self._children.items()):
            lines.append(f"{base}_created{_labels(zip(self.labelnames, values))} "
                         f"{go_float(child[-1])}")
        return lines


class Counter(_Metric):
    kind = "counter"

    def inc(self, values: Tuple[str, ...], amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("Counters can only be incremented by non-negative amounts.")
        with self._lock:
            self._child(values)[0] += amount

    def render(self) -> List[str]:
        base = self.name[:-len("_total")] if self.name.endswith("_total") else self.name
        with self._lock:
            lines = self._header(f"{base}_total", "counter")
            for values, child in list(self._children.items()):
                lines.append(f"{base}_total{_labels(zip(self.labelnames, values))} "
                             f"{go_float(child[0])}")
            return lines + self._created(base)


class Gauge(_Metric):
    kind = "gauge"

    def set(self, values: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._child(values)[0] = float(value)

    def inc(self, values: Tuple[str, ...], amount: float = 1.0) -> None:
        with self._lock:
            self._child(values)[0] += amount

    def render(self) -> List[str]:
        with self._lock:
            lines = self._header(self.name, "gauge")
            for values, child in list(self._children.items()):
                lines.append(f"{self.name}{_labels(zip(self.labelnames, values))} "
                             f"{go_float(child[0])}")
            return lines


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labelnames: Tuple[str, ...],
                 buckets: Optional[Iterable[float]] = None):
        super().__init__(name, doc, labelnames)
        bounds = sorted(float(b) for b in (buckets or DEFAULT_BUCKETS))
        if bounds[-1] != math.inf:
            bounds.append(math.inf)
        self.bounds = tuple(bounds)

    def _new(self) -> list:
        # per-bucket counts (not cumulative), sum, created
        return [[0.0] * len(self.bounds), 0.0, time.time()]

    def observe(self, values: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            child = self._child(values)
            for i, bound in enumerate(self.bounds):
                if amount <= bound:
                    child[0][i] += 1.0
                    break
            child[1] += amount

    def render(self) -> List[str]:
        with self._lock:
            lines = self._header(self.name, "histogram")
            for values, child in list(self._children.items()):
                pairs = list(zip(self.labelnames, values))
                cum = 0.0
                for bound, n in zip(self.bounds, child[0]):
                    cum += n
                    lines.append(f"{self.name}_bucket"
                                 f"{_labels(pairs + [('le', go_float(bound))])} {go_float(cum)}")
                lines.append(f"{self.name}_count{_labels(pairs)} {go_float(cum)}")
                lines.append(f"{self.name}_sum{_labels(pairs)} {go_float(child[1])}")
            return lines + self._created(self.name)


class Registry:
    """Metric families in registration order; one name registers once."""

    def __init__(self):
        self._metrics: Dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def register(self, metric: _Metric) -> None:
        with self._lock:
            if metric.name in self._metrics:
                raise ValueError(f"Duplicated timeseries in Registry: {metric.name}")
            self._metrics[metric.name] = metric

    def expose(self) -> bytes:
        with self._lock:
            metrics = list(self._metrics.values())
        lines: List[str] = []
        for m in metrics:
            lines += m.render()
        return ("\n".join(lines) + "\n").encode() if lines else b""


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsScope:
    """A labelled view over a shared registry; child scopes append labels."""

    def __init__(
        self,
        registry: Optional[Registry] = None,
        const_labels: Optional[Dict[str, str]] = None,
        _cache: Optional[Dict[Tuple[str, str], object]] = None,
        _lock: Optional[threading.Lock] = None,
    ):
        self.registry = registry or Registry()
        self.const_labels: Dict[str, str] = dict(const_labels or {})
        # metric objects are shared across scopes (one name registers once),
        # keyed by (kind, name)
        self._cache: Dict[Tuple, object] = _cache if _cache is not None else {}
        self._lock = _lock if _lock is not None else threading.Lock()

    def child(self, **labels: str) -> "MetricsScope":
        merged = dict(self.const_labels)
        merged.update(labels)
        return MetricsScope(self.registry, merged, self._cache, self._lock)

    def _get(self, kind: str, name: str, doc: str, extra_labels: Iterable[str], **kw):
        # the label set is fixed at first creation and always holds the
        # hierarchy labels, so creation order (root vs child scope) does not
        # matter; _Bound fills any label it has no value for with ""
        labelnames = tuple(sorted(
            {LABEL_NAMESPACE, LABEL_COMPONENT, LABEL_ENDPOINT}
            | set(self.const_labels) | set(extra_labels)))
        with self._lock:
            entry = self._cache.get((kind, name))
            if entry is None:
                metric = _KINDS[kind](name, doc, labelnames, **kw)
                self.registry.register(metric)
                self._cache[(kind, name)] = entry = metric
        return entry

    def counter(self, name: str, doc: str = "", extra_labels: Iterable[str] = ()):
        return _Bound(self._get("counter", name, doc, extra_labels), self.const_labels)

    def gauge(self, name: str, doc: str = "", extra_labels: Iterable[str] = ()):
        return _Bound(self._get("gauge", name, doc, extra_labels), self.const_labels)

    def histogram(self, name: str, doc: str = "", extra_labels: Iterable[str] = (),
                  buckets=None):
        kw = {"buckets": buckets} if buckets else {}
        return _Bound(self._get("histogram", name, doc, extra_labels, **kw),
                      self.const_labels)

    def expose(self) -> bytes:
        return self.registry.expose()


class _Bound:
    """A metric pre-bound to the scope's constant labels; extra labels fill at use."""

    __slots__ = ("_metric", "_const")

    def __init__(self, metric, const: Dict[str, str]):
        self._metric = metric
        self._const = const

    def _values(self, extra: Dict[str, str]) -> Tuple[str, ...]:
        return tuple(str(extra.get(ln, self._const.get(ln, "")))
                     for ln in self._metric.labelnames)

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        self._metric.inc(self._values(labels), amount)

    def dec(self, amount: float = 1.0, **labels: str) -> None:
        self._metric.inc(self._values(labels), -amount)

    def set(self, value: float, **labels: str) -> None:
        self._metric.set(self._values(labels), value)

    def observe(self, value: float, **labels: str) -> None:
        self._metric.observe(self._values(labels), value)
