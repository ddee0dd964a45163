"""SLO accounting plane: per-class SLA targets, rolling attainment, burn rate.

The port's copy of the reference package's runtime/slo.py, the one source
of truth for both halves of a service-level objective:

- **The promise**: ``SlaSpec``, a named class (``interactive`` /
  ``standard`` / ``batch``, extensible via ``DTPU_SLA_CLASSES``) with TTFT /
  ITL targets and an optional e2e deadline. The HTTP frontend resolves a
  request's class (request ``sla`` field > ``x-dtpu-sla`` header > default),
  applies per-model overrides from the model card's runtime_config, and
  stamps the spec into the request-plane annotation (``ANNOTATION_SLA``)
  exactly like the traceparent: router, engine and flight recorder all
  read the same dict.

- **The ledger**: ``SloAccountant``, per-``(model, sla_class)`` rolling
  attainment over 1m/5m/1h windows plus a cumulative ``total`` window,
  error-budget burn rate against a configurable objective, and
  goodput-vs-throughput token counters, on an injectable monotonic clock
  (any ``() -> float``). All accounting is host-side arithmetic on
  timestamps the serving path already takes: no device sync.

Exported metrics (through ``runtime/metrics.py`` scopes):
``dtpu_slo_attainment_ratio{model,sla_class,window,slo}``,
``dtpu_slo_burn_rate{model,sla_class,window}``,
``dtpu_goodput_tokens_total{model,sla_class}``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

from .config import (
    ENV_SLA_CLASSES,
    ENV_SLA_DEFAULT,
    ENV_SLO_OBJECTIVE,
    env_float,
    env_str,
)
from .logging import get_logger

log = get_logger("slo")

# annotation key on PreprocessedRequest.annotations (rides the request plane
# like "traceparent"); HTTP header the frontend accepts the class from
ANNOTATION_SLA = "sla"
SLA_HEADER = "x-dtpu-sla"

# the rolling windows every consumer reads, plus the cumulative ledger
WINDOWS: Dict[str, float] = {"1m": 60.0, "5m": 300.0, "1h": 3600.0}
TOTAL_WINDOW = "total"
_BUCKET_S = 10.0  # rolling-window resolution
_RETAIN_S = max(WINDOWS.values())

DEFAULT_OBJECTIVE = 0.99
DEFAULT_CLASS = "standard"


@dataclasses.dataclass(frozen=True)
class SlaSpec:
    """One request's promise: class name + latency targets (+ e2e deadline).

    ``deadline_s`` is a *relative* budget from frontend receipt (0 = none);
    the absolute anchor travels separately as ``t0_ns`` in the annotation so
    downstream hops on the same wall clock can compute remaining budget.
    """

    sla_class: str
    ttft_target_s: float
    itl_target_s: float
    deadline_s: float = 0.0

    def to_annotation(self, t0_ns: Optional[int] = None) -> Dict[str, Any]:
        ann: Dict[str, Any] = {
            "class": self.sla_class,
            "ttft_target_s": self.ttft_target_s,
            "itl_target_s": self.itl_target_s,
            "deadline_s": self.deadline_s,
        }
        ann["t0_ns"] = int(t0_ns) if t0_ns is not None else time.time_ns()
        return ann


def spec_from_annotations(annotations: Dict[str, Any]) -> Optional[SlaSpec]:
    """Parse the ``sla`` annotation back into a spec (None when absent or
    malformed — a bad annotation must degrade to unclassified, not 500)."""
    ann = (annotations or {}).get(ANNOTATION_SLA)
    if not isinstance(ann, dict) or "class" not in ann:
        return None
    try:
        return SlaSpec(
            sla_class=str(ann["class"]),
            ttft_target_s=float(ann.get("ttft_target_s", 0.0)),
            itl_target_s=float(ann.get("itl_target_s", 0.0)),
            deadline_s=float(ann.get("deadline_s", 0.0)),
        )
    except (TypeError, ValueError):
        return None


def sla_t0_ns(annotations: Dict[str, Any]) -> Optional[int]:
    """Frontend receipt stamp (unix ns) riding the sla annotation."""
    ann = (annotations or {}).get(ANNOTATION_SLA)
    if isinstance(ann, dict):
        try:
            return int(ann["t0_ns"])
        except (KeyError, TypeError, ValueError):
            return None
    return None


# ---------------------------------------------------------------------------
# class registry: built-in defaults < env < per-model card overrides
# ---------------------------------------------------------------------------

_BUILTIN_CLASSES: Dict[str, SlaSpec] = {
    "interactive": SlaSpec("interactive", ttft_target_s=0.5, itl_target_s=0.05),
    "standard": SlaSpec("standard", ttft_target_s=2.0, itl_target_s=0.2),
    "batch": SlaSpec("batch", ttft_target_s=30.0, itl_target_s=1.0),
}


def _parse_class_spec(name: str, body: str) -> SlaSpec:
    """``ttft=0.5,itl=0.05,deadline=30`` -> SlaSpec (keys optional; unset
    targets inherit the built-in class of the same name when one exists)."""
    base = _BUILTIN_CLASSES.get(name, SlaSpec(name, 0.0, 0.0))
    fields = {
        "ttft": base.ttft_target_s,
        "itl": base.itl_target_s,
        "deadline": base.deadline_s,
    }
    for part in body.split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in fields:
            raise ValueError(f"unknown SLA target {k!r} (want ttft/itl/deadline)")
        fields[k] = float(v)
    return SlaSpec(name, fields["ttft"], fields["itl"], fields["deadline"])


def sla_classes() -> Dict[str, SlaSpec]:
    """The effective named-class table: built-ins overlaid with
    ``DTPU_SLA_CLASSES`` ("name:ttft=0.5,itl=0.05;name2:ttft=30"). A
    malformed env spec logs and falls back to built-ins — SLA config must
    never take the frontend down."""
    out = dict(_BUILTIN_CLASSES)
    raw = env_str(ENV_SLA_CLASSES, "")
    if not raw:
        return out
    try:
        for entry in raw.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, _, body = entry.partition(":")
            name = name.strip()
            if not name:
                raise ValueError(f"class entry {entry!r} has no name")
            out[name] = _parse_class_spec(name, body)
    except ValueError:
        log.exception("bad %s spec %r; using built-in SLA classes",
                      ENV_SLA_CLASSES, raw)
        return dict(_BUILTIN_CLASSES)
    return out


def default_class() -> str:
    return env_str(ENV_SLA_DEFAULT, DEFAULT_CLASS)


def resolve_sla(
    name: Optional[str],
    model_overrides: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Optional[SlaSpec]:
    """Resolve a class name to its spec, applying per-model target
    overrides from the model card's ``runtime_config.sla_classes``
    (``{"interactive": {"ttft_target_s": 0.3}}``). ``None``/empty name
    means the default class; an unknown name returns None (the frontend
    turns that into a 400 rather than silently serving untracked)."""
    explicit = bool(name)
    name = name or default_class()
    spec = sla_classes().get(name)
    if spec is None and not explicit:
        # a typo'd DTPU_SLA_DEFAULT must not 400 every unclassed request
        # (same never-take-the-frontend-down rule as the class table):
        # fall back to the built-in default, loudly
        log.warning("%s names unknown class %r; using %r",
                    ENV_SLA_DEFAULT, name, DEFAULT_CLASS)
        name = DEFAULT_CLASS
        spec = sla_classes().get(name)
    ov = (model_overrides or {}).get(name)
    if ov:
        base = spec or SlaSpec(name, 0.0, 0.0)
        try:
            spec = SlaSpec(
                name,
                float(ov.get("ttft_target_s", base.ttft_target_s)),
                float(ov.get("itl_target_s", base.itl_target_s)),
                float(ov.get("deadline_s", base.deadline_s)),
            )
        except (TypeError, ValueError):
            log.warning("bad sla_classes override for %r on model card; "
                        "ignoring", name)
    return spec


# ---------------------------------------------------------------------------
# attainment math
# ---------------------------------------------------------------------------


def attainment(values: Iterable[float], target: float) -> float:
    """Fraction of ``values`` at or under ``target`` (0.0 for no samples)."""
    vals = list(values)
    if not vals:
        return 0.0
    return sum(1 for v in vals if v <= target) / len(vals)


def burn_rate(att: Optional[float], objective: float) -> Optional[float]:
    """Error-budget burn rate: observed error rate over the budgeted error
    rate. 1.0 = spending budget exactly on schedule; >1 = burning faster
    than the objective allows; None when there is nothing observed."""
    if att is None:
        return None
    allowed = max(1.0 - objective, 1e-9)
    return (1.0 - att) / allowed


# ---------------------------------------------------------------------------
# the accountant
# ---------------------------------------------------------------------------


class _Counts:
    """One accumulation cell (a time bucket or a cumulative total)."""

    __slots__ = ("ttft_ok", "ttft_n", "itl_ok", "itl_n", "met", "requests",
                 "goodput_tokens", "tokens")

    def __init__(self) -> None:
        self.ttft_ok = 0
        self.ttft_n = 0
        self.itl_ok = 0
        self.itl_n = 0
        self.met = 0
        self.requests = 0
        self.goodput_tokens = 0
        self.tokens = 0

    def add(self, other: "_Counts") -> None:
        self.ttft_ok += other.ttft_ok
        self.ttft_n += other.ttft_n
        self.itl_ok += other.itl_ok
        self.itl_n += other.itl_n
        self.met += other.met
        self.requests += other.requests
        self.goodput_tokens += other.goodput_tokens
        self.tokens += other.tokens


class _Series:
    """Per-(model, sla_class) state: bucket ring + cumulative totals."""

    __slots__ = ("buckets", "total", "spec")

    def __init__(self, spec: SlaSpec) -> None:
        self.buckets: Dict[int, _Counts] = {}
        self.total = _Counts()
        self.spec = spec


class SloAccountant:
    """Rolling per-(model, sla_class) SLO ledger on an injectable clock.

    ``clock`` is any monotonic ``() -> float``. Observations are compared against
    the *per-request* spec (targets may differ per model override), so the
    ledger is correct even when one class means different numbers on
    different models. Thread-safe: the engine feeds it from executor
    threads, the status server reads it from the event loop.
    """

    def __init__(
        self,
        clock: Optional[Callable[[], float]] = None,
        objective: Optional[float] = None,
        metrics=None,
    ):
        self._clock = clock if clock is not None else time.monotonic
        self.objective = (
            objective if objective is not None
            else env_float(ENV_SLO_OBJECTIVE, DEFAULT_OBJECTIVE)
        )
        self._lock = threading.Lock()
        self._series: Dict[tuple, _Series] = {}
        self._metrics = None
        self._goodput_c = None
        self._attain_g = None
        self._burn_g = None
        if metrics is not None:
            self.bind_metrics(metrics)

    # -- wiring ---------------------------------------------------------------
    def bind_metrics(self, scope) -> None:
        """Attach a MetricsScope: the goodput counter increments on every
        record; attainment/burn gauges refresh on export_metrics()."""
        from . import metrics as M

        self._metrics = scope
        self._goodput_c = scope.counter(
            M.GOODPUT_TOKENS, "output tokens of requests that met their SLO",
            extra_labels=(M.LABEL_MODEL, M.LABEL_SLA_CLASS),
        )
        self._attain_g = scope.gauge(
            M.SLO_ATTAINMENT, "fraction of requests meeting the SLO",
            extra_labels=(M.LABEL_MODEL, M.LABEL_SLA_CLASS, M.LABEL_WINDOW,
                          "slo"),
        )
        self._burn_g = scope.gauge(
            M.SLO_BURN_RATE, "error-budget burn rate (1.0 = on schedule)",
            extra_labels=(M.LABEL_MODEL, M.LABEL_SLA_CLASS, M.LABEL_WINDOW),
        )

    # -- producer side --------------------------------------------------------
    def record(
        self,
        model: str,
        spec: SlaSpec,
        ttft_s: Optional[float] = None,
        itl_s: Optional[float] = None,
        output_tokens: int = 0,
        e2e_s: Optional[float] = None,
    ) -> bool:
        """Account one finished request; returns whether it met its SLO.

        ``itl_s`` is the request's mean inter-token gap (None when fewer
        than two tokens streamed — an unobserved ITL cannot violate).
        """
        now = self._clock()
        ttft_ok = ttft_s is not None and ttft_s <= spec.ttft_target_s
        itl_ok = itl_s is None or itl_s <= spec.itl_target_s
        deadline_ok = (
            spec.deadline_s <= 0.0
            or (e2e_s is not None and e2e_s <= spec.deadline_s)
        )
        met = ttft_ok and itl_ok and deadline_ok
        key = (model, spec.sla_class)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(spec)
            series.spec = spec  # latest targets win for the payload
            bidx = int(now / _BUCKET_S)
            bucket = series.buckets.get(bidx)
            if bucket is None:
                bucket = series.buckets[bidx] = _Counts()
                self._prune(series, now)
            for cell in (bucket, series.total):
                cell.requests += 1
                if ttft_s is not None:
                    cell.ttft_n += 1
                    cell.ttft_ok += 1 if ttft_ok else 0
                if itl_s is not None:
                    cell.itl_n += 1
                    cell.itl_ok += 1 if itl_s <= spec.itl_target_s else 0
                cell.met += 1 if met else 0
                cell.tokens += int(output_tokens)
                if met:
                    cell.goodput_tokens += int(output_tokens)
        if met and output_tokens and self._goodput_c is not None:
            self._goodput_c.inc(
                int(output_tokens), model=model, sla_class=spec.sla_class
            )
        return met

    @staticmethod
    def _prune(series: _Series, now: float) -> None:
        floor = int((now - _RETAIN_S) / _BUCKET_S) - 1
        for bidx in [b for b in series.buckets if b < floor]:
            del series.buckets[bidx]

    # -- consumer side --------------------------------------------------------
    def _window_counts(self, series: _Series, window: str, now: float) -> _Counts:
        if window == TOTAL_WINDOW:
            return series.total
        span = WINDOWS[window]
        floor = int((now - span) / _BUCKET_S) + 1  # whole buckets inside span
        agg = _Counts()
        for bidx, bucket in series.buckets.items():
            if bidx >= floor:
                agg.add(bucket)
        return agg

    def attainment(
        self,
        model: str,
        sla_class: str,
        window: str = TOTAL_WINDOW,
        kind: str = "combined",
    ) -> Optional[float]:
        """Attainment ratio over ``window`` — ``kind`` picks the objective:
        ``ttft`` / ``itl`` / ``combined`` (ttft AND itl AND deadline).
        None when nothing was observed in the window."""
        with self._lock:
            series = self._series.get((model, sla_class))
            if series is None:
                return None
            c = self._window_counts(series, window, self._clock())
        if kind == "ttft":
            return c.ttft_ok / c.ttft_n if c.ttft_n else None
        if kind == "itl":
            return c.itl_ok / c.itl_n if c.itl_n else None
        return c.met / c.requests if c.requests else None

    def burn_rate(
        self, model: str, sla_class: str, window: str = TOTAL_WINDOW
    ) -> Optional[float]:
        return burn_rate(
            self.attainment(model, sla_class, window), self.objective
        )

    def keys(self) -> List[tuple]:
        with self._lock:
            return sorted(self._series)

    def snapshot(self) -> Dict[str, Any]:
        """The ``/debug/slo`` payload: every (model, class) series with all
        windows, targets, burn rates and goodput counters, rounded."""
        now = self._clock()
        out: Dict[str, Any] = {
            "objective": self.objective,
            "windows": sorted(WINDOWS) + [TOTAL_WINDOW],
            "models": {},
        }

        def _r(x: Optional[float]) -> Optional[float]:
            return None if x is None else round(x, 6)

        with self._lock:
            items = [
                (key, series, {
                    w: self._window_counts(series, w, now)
                    for w in list(WINDOWS) + [TOTAL_WINDOW]
                })
                for key, series in sorted(self._series.items())
            ]
        for (model, cls), series, per_window in items:
            spec = series.spec
            windows_obj = {}
            for w, c in per_window.items():
                att_t = c.ttft_ok / c.ttft_n if c.ttft_n else None
                att_i = c.itl_ok / c.itl_n if c.itl_n else None
                att_c = c.met / c.requests if c.requests else None
                windows_obj[w] = {
                    "requests": c.requests,
                    "ttft_attainment": _r(att_t),
                    "itl_attainment": _r(att_i),
                    "attainment": _r(att_c),
                    "burn_rate": _r(burn_rate(att_c, self.objective)),
                    "goodput_tokens": c.goodput_tokens,
                    "total_tokens": c.tokens,
                    "goodput_ratio": _r(
                        c.goodput_tokens / c.tokens if c.tokens else None
                    ),
                }
            out["models"].setdefault(model, {})[cls] = {
                "targets": {
                    "ttft_target_s": spec.ttft_target_s,
                    "itl_target_s": spec.itl_target_s,
                    "deadline_s": spec.deadline_s,
                },
                "windows": windows_obj,
            }
        return out

    def export_metrics(self) -> None:
        """Refresh the attainment/burn gauges from the rolling windows
        (called right before a scrape / debug read; no-op when unbound).

        An empty window writes the neutral values (attainment 1.0, burn
        0.0) instead of skipping: skipping would freeze a drained 1m/5m
        gauge at its last value — a one-minute violation burst would keep
        exporting page-now burn rates for hours after traffic stopped.
        No traffic burns no error budget; request counts live in the
        ``/debug/slo`` payload for consumers that need to tell idle from
        perfect."""
        if self._attain_g is None:
            return
        for model, cls in self.keys():
            for w in list(WINDOWS) + [TOTAL_WINDOW]:
                for kind in ("ttft", "itl", "combined"):
                    att = self.attainment(model, cls, w, kind)
                    self._attain_g.set(
                        att if att is not None else 1.0,
                        model=model, sla_class=cls, window=w, slo=kind,
                    )
                br = self.burn_rate(model, cls, w)
                self._burn_g.set(
                    br if br is not None else 0.0,
                    model=model, sla_class=cls, window=w,
                )


# ---------------------------------------------------------------------------
# flight-recorder integration: the /debug/requests?id= budget breakdown
# ---------------------------------------------------------------------------


def budget_breakdown(flight: Dict[str, Any]) -> Optional[Dict[str, Any]]:
    """From one flight-recorder timeline, the SLO view of a request: where
    the TTFT budget went (queue / prefill / decode shares of the target)
    and the remaining e2e deadline. Needs the engine-stamped ``queued``
    event to carry the sla fields; returns None for unclassified flights."""
    events = flight.get("events") or []

    def _find(kind: str):
        for e in events:
            if e["event"].get("kind") == kind:
                return e
        return None

    queued = _find("queued")
    if queued is None:
        return None
    ev = queued["event"]
    if "sla_class" not in ev:
        return None
    ttft_target_s = float(ev.get("ttft_target_s", 0.0))
    deadline_s = float(ev.get("deadline_s", 0.0))
    t_queued = queued["timestamp"]
    admitted = _find("admitted")
    first = _find("first_token")
    terminal = _find("finish") or _find("abort")
    out: Dict[str, Any] = {
        "sla_class": ev["sla_class"],
        "ttft_target_s": ttft_target_s,
        "deadline_s": deadline_s,
    }

    def _ms(a, b) -> float:
        return round((b["timestamp"] - a["timestamp"]) / 1e6, 3)

    phases: Dict[str, float] = {}
    if admitted is not None:
        phases["queue_ms"] = _ms(queued, admitted)
        if first is not None:
            phases["prefill_ms"] = _ms(admitted, first)
    if first is not None:
        phases["ttft_ms"] = _ms(queued, first)
        if terminal is not None:
            phases["decode_ms"] = _ms(first, terminal)
    out.update(phases)
    if ttft_target_s > 0:
        target_ms = ttft_target_s * 1e3
        out["budget_shares"] = {
            name[:-3]: round(phases[name] / target_ms, 4)
            for name in ("queue_ms", "prefill_ms")
            if name in phases
        }
        if "ttft_ms" in phases:
            out["ttft_met"] = phases["ttft_ms"] <= target_ms
    if deadline_s > 0 and terminal is not None:
        out["deadline_remaining_s"] = round(
            deadline_s - (terminal["timestamp"] - t_queued) / 1e9, 3
        )
    return out


# ---------------------------------------------------------------------------
# /debug/slo payload (shared by StatusServer and the frontend)
# ---------------------------------------------------------------------------


def debug_slo_payload(accountant: Optional["SloAccountant"]) -> Dict[str, Any]:
    """The ONE ``/debug/slo`` body both the worker StatusServer and the HTTP
    frontend serve."""
    if accountant is None:
        return {"objective": None, "windows": [], "models": {}}
    accountant.export_metrics()
    return accountant.snapshot()


# ---------------------------------------------------------------------------
# process-global accountant (the engine/worker-side ledger, like the flight
# recorder: importable anywhere without wiring)
# ---------------------------------------------------------------------------

_global_accountant: Optional[SloAccountant] = None
_global_lock = threading.Lock()


def get_slo_accountant() -> SloAccountant:
    global _global_accountant
    if _global_accountant is None:
        with _global_lock:
            if _global_accountant is None:
                _global_accountant = SloAccountant()
    return _global_accountant


def set_slo_accountant(accountant: Optional[SloAccountant]) -> None:
    global _global_accountant
    _global_accountant = accountant
