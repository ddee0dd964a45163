"""Layered runtime configuration and the ``DTPU_*`` environment catalog.

The port's copy of the reference package's runtime/config.py, holding the
names the serving plane, the KV router and the health and observability
planes read (the reference's catalog also names the planes of later
slices). Precedence: explicit kwargs > env >
config file (``DTPU_CONFIG``, json or toml) > defaults.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, Optional

ENV_LOG = "DTPU_LOG"                                  # log level (debug/info/warn/error)
ENV_LOG_JSONL = "DTPU_LOGGING_JSONL"                  # structured JSONL logging on/off
ENV_EVENT_PLANE = "DTPU_EVENT_PLANE"                  # zmq | inproc (zmq: the port's own broker)
ENV_REQUEST_PLANE = "DTPU_REQUEST_PLANE"              # tcp | http
ENV_STORE = "DTPU_STORE"                              # mem | file | tcp | etcd
ENV_STORE_PATH = "DTPU_STORE_PATH"                    # file path / tcp host:port / etcd endpoint
ENV_HOST_IP = "DTPU_HOST_IP"                          # advertised host for request plane
ENV_LEASE_TTL_S = "DTPU_LEASE_TTL_S"                  # discovery lease ttl
ENV_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT = "DTPU_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT"
ENV_NAMESPACE = "DTPU_NAMESPACE"
ENV_MIGRATION_LIMIT = "DTPU_MIGRATION_LIMIT"
ENV_ROUTER_REPLICA_SYNC = "DTPU_ROUTER_REPLICA_SYNC"  # replicated KV routers share state
ENV_ROUTER_TOPK = "DTPU_ROUTER_TOPK"                  # two-stage routing candidate K
ENV_ROUTER_SHARDS = "DTPU_ROUTER_SHARDS"              # postings/snapshot index shards
ENV_ROUTER_POSTINGS_BUCKET = "DTPU_ROUTER_POSTINGS_BUCKET"  # per-block postings cap
ENV_KVBM_HOST_CACHE_GB = "DTPU_KVBM_HOST_CACHE_GB"    # G2 host memory pool size
ENV_KVBM_DISK_CACHE_GB = "DTPU_KVBM_DISK_CACHE_GB"    # G3 local disk pool size
ENV_KVBM_DISK_PATH = "DTPU_KVBM_DISK_PATH"
ENV_KVBM_REMOTE = "DTPU_KVBM_REMOTE"                  # G4 block store host:port
ENV_HTTP_PORT = "DTPU_HTTP_PORT"
ENV_BUSY_THRESHOLD = "DTPU_BUSY_THRESHOLD"
ENV_CONFIG_FILE = "DTPU_CONFIG"                       # layered config file (json/toml)
ENV_SYSTEM_PORT = "DTPU_SYSTEM_PORT"                  # worker status server port
ENV_SYSTEM_HOST = "DTPU_SYSTEM_HOST"
ENV_CANARY_WAIT_TIME = "DTPU_CANARY_WAIT_TIME"        # s between canary probes
# observability (runtime/tracing.py, llm/audit.py)
ENV_AUDIT_SINKS = "DTPU_AUDIT_SINKS"                  # stderr,jsonl:<path>,event
ENV_AUDIT_FORCE_LOGGING = "DTPU_AUDIT_FORCE_LOGGING"  # audit every request
ENV_AUDIT_SUBJECT = "DTPU_AUDIT_SUBJECT"              # event-plane audit topic
ENV_OTLP_ENDPOINT = "DTPU_OTLP_ENDPOINT"              # OTLP/HTTP collector
ENV_TRACE_JSONL = "DTPU_TRACE_JSONL"                  # span JSONL file
# request flight recorder (runtime/flight_recorder.py) + step telemetry
ENV_FLIGHT_CAPACITY = "DTPU_FLIGHT_CAPACITY"          # retained request timelines
ENV_FLIGHT_DUMP = "DTPU_FLIGHT_DUMP"                  # JSONL path for failure dumps
ENV_SLOW_STEP_MS = "DTPU_SLOW_STEP_MS"                # slow-step log threshold
ENV_ASYNC_PREP = "DTPU_ASYNC_PREP"                    # async host chunk prep on/off
# SLO accounting (runtime/slo.py)
ENV_SLA_CLASSES = "DTPU_SLA_CLASSES"                  # "interactive:ttft=0.5,itl=0.05;batch:ttft=30"
ENV_SLA_DEFAULT = "DTPU_SLA_DEFAULT"                  # class stamped when a request names none
ENV_SLO_OBJECTIVE = "DTPU_SLO_OBJECTIVE"              # attainment objective for burn rate (0.99)
# fleet observability (runtime/health.py detectors, llm/fleet.py /debug/fleet)
ENV_FLEET_FANOUT = "DTPU_FLEET_FANOUT"                # /debug/fleet concurrent worker fetches
ENV_FLEET_TIMEOUT_S = "DTPU_FLEET_TIMEOUT_S"          # per-worker snapshot fetch timeout (s)
ENV_HEALTH_MIN_INTERVAL_S = "DTPU_HEALTH_MIN_INTERVAL_S"  # min s between health events per subject
ENV_HEALTH_DRIFT_RATIO = "DTPU_HEALTH_DRIFT_RATIO"    # measured/predicted step-time trip ratio
# disaggregated prefill/decode (engine/transfer.py, llm/prefill_router.py)
ENV_STREAM_WINDOW = "DTPU_STREAM_WINDOW"              # streamed fetch window (blocks)
ENV_STREAM_WAIT_S = "DTPU_STREAM_WAIT_S"              # streamed fetch commit-wait budget
ENV_DEVICE_TRANSFER = "DTPU_DEVICE_TRANSFER"          # device (CUDA IPC) pull path on/off
ENV_ICI_TRANSFER = "DTPU_ICI_TRANSFER"                # same-process device move on/off
ENV_KV_WIRE = "DTPU_KV_WIRE"                          # advertised kv wire class
ENV_STREAM_KV = "DTPU_STREAM_KV"                      # streamed (vs sequential) disagg dispatch
ENV_DEFLECT = "DTPU_DEFLECT"                          # prefill deflection valve on/off
ENV_DEFLECT_MAX_TOKENS = "DTPU_DEFLECT_MAX_TOKENS"    # short-prompt deflection bound
ENV_DEFLECT_OVERLAP = "DTPU_DEFLECT_OVERLAP"          # decode-pool radix-hit deflection share
ENV_DEFLECT_MARGIN = "DTPU_DEFLECT_MARGIN"            # load-skew deflection margin
ENV_PREFILL_BLOCK_MS = "DTPU_PREFILL_BLOCK_MS"        # per-block prefill cost prior
ENV_KV_BYTES_PER_BLOCK = "DTPU_KV_BYTES_PER_BLOCK"    # wire-cost bytes/block override
# fleet-wide KV reuse (kvbm/directory.py, llm/prefill_router.py): the global
# content-addressed block directory over the discovery plane and the
# fetch-vs-recompute decision (ops/costs.py)
ENV_GLOBAL_KV = "DTPU_GLOBAL_KV"                      # global KV directory on/off
ENV_GLOBAL_KV_TTL_S = "DTPU_GLOBAL_KV_TTL_S"          # directory entry ttl (s)
ENV_GLOBAL_KV_DEDUPE = "DTPU_GLOBAL_KV_DEDUPE"        # max advertised holders per hash
ENV_GLOBAL_KV_FETCH_MARGIN = "DTPU_GLOBAL_KV_FETCH_MARGIN"  # fetch <= margin*recompute gate
# planned reclaims + checkpoint/restore (engine/drain.py, engine/checkpoint.py)
ENV_DRAIN_DEADLINE_S = "DTPU_DRAIN_DEADLINE_S"        # default reclaim deadline (s)
ENV_DRAIN_MARGIN_S = "DTPU_DRAIN_MARGIN_S"            # stop evacuating this early (s)
ENV_CKPT_DIR = "DTPU_CKPT_DIR"                        # G3 checkpoint directory
ENV_CKPT_MAX_BLOCKS = "DTPU_CKPT_MAX_BLOCKS"          # sealed blocks per checkpoint cap
# weights that outlive a worker (engine/weight_service.py)
ENV_WEIGHT_SERVICE = "DTPU_WEIGHT_SERVICE"            # the weight owner's unix socket
ENV_WEIGHT_SHM = "DTPU_WEIGHT_SHM"                    # the owner's shared-memory directory
# DTPU_RETRY_* / DTPU_CB_* (runtime/resilience.py) and DTPU_FAULTS
# (runtime/faults.py) are read where they apply

_TRUTHY = {"1", "true", "yes", "on", "enabled"}


def is_truthy(val: Optional[str]) -> bool:
    if val is None:
        return False
    return val.strip().lower() in _TRUTHY


def env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def env_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def env_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return is_truthy(raw)


def env_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def default_store_path() -> str:
    """The file store's directory when none is named: under the temp dir."""
    return os.path.join(tempfile.gettempdir(), "dtpu_store")


@dataclasses.dataclass
class RuntimeConfig:
    """Top-level runtime knobs; every field has an env override."""

    event_plane: str = "inproc"          # inproc | zmq (runtime/event_plane/tcp_plane.py)
    request_plane: str = "tcp"           # tcp | http (request_plane/http.py)
    store: str = "mem"                   # mem | file | tcp | etcd
    store_path: str = dataclasses.field(default_factory=default_store_path)
    host_ip: str = "127.0.0.1"
    lease_ttl_s: float = 10.0
    # DistributedRuntime.shutdown drains its task tracker this long
    graceful_shutdown_timeout_s: float = 30.0

    @classmethod
    def from_env(cls, **overrides: Any) -> "RuntimeConfig":
        """defaults < config file (DTPU_CONFIG) < env < kwargs."""
        base: Dict[str, Any] = {}
        cfg_file = os.environ.get(ENV_CONFIG_FILE)
        if cfg_file:
            base.update(load_config_file(cfg_file))
        defaults = cls()

        def layered(field: str, env_name: str, conv) -> Any:
            value = getattr(defaults, field)
            if field in base:
                try:
                    value = conv(base[field])
                except (TypeError, ValueError):
                    pass
            raw = os.environ.get(env_name)
            if raw is None or raw == "":
                return value
            try:
                return conv(raw)
            except (TypeError, ValueError):
                return value

        cfg = cls(
            event_plane=layered("event_plane", ENV_EVENT_PLANE, str),
            request_plane=layered("request_plane", ENV_REQUEST_PLANE, str),
            store=layered("store", ENV_STORE, str),
            store_path=layered("store_path", ENV_STORE_PATH, str),
            host_ip=layered("host_ip", ENV_HOST_IP, str),
            lease_ttl_s=layered("lease_ttl_s", ENV_LEASE_TTL_S, float),
            graceful_shutdown_timeout_s=layered(
                "graceful_shutdown_timeout_s",
                ENV_WORKER_GRACEFUL_SHUTDOWN_TIMEOUT, float),
        )
        for k, v in overrides.items():
            if v is not None:
                setattr(cfg, k, v)
        return cfg


def load_config_file(path: str) -> Dict[str, Any]:
    """json, or toml through the standard library's tomllib."""
    with open(path, "rb") as f:
        raw = f.read()
    if path.endswith(".toml"):
        import tomllib

        return tomllib.loads(raw.decode())
    return json.loads(raw.decode())
