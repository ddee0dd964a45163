"""python -m dynamo_tpu_torch.engine — a TorchEngine worker of the serving plane.

The port's counterpart of the reference's ``python -m dynamo_tpu.engine``:
builds a TorchEngine (through ``run.build_engine``, the code path of
``python -m dynamo_tpu_torch.run``), serves it on the request plane behind
the Backend operator (detokenization, stop strings), and publishes its
model card under its discovery lease, so that an OpenAI frontend
(``python -m dynamo_tpu_torch.frontend``) on the same store finds it:

    python -m dynamo_tpu_torch.runtime.discovery.netstore --port 7460
    python -m dynamo_tpu_torch.engine --store tcp --store-path 127.0.0.1:7460 \\
        --preset llama3-8b --model llama3-8b
    python -m dynamo_tpu_torch.frontend --store tcp --store-path 127.0.0.1:7460 --port 8000

It serves on the GPU unless ``--device cpu`` is given, and raises without
one. Model selection: ``--model-path`` (an HF checkpoint directory or hub
reference, as run.py's ``out=``) or ``--preset`` (random weights from
``--seed``). The engine flags are the reference worker's, with its
defaults; of the parallelism flags ``--tp`` (and the followers'
``--multihost``) are defined (the others are queued in ROADMAP.md, and
argparse refuses them). ``--weight-service SOCK`` (``DTPU_WEIGHT_SERVICE``)
with ``--model-path`` imports the checkpoint's weights from a weight owner
(``python -m dynamo_tpu_torch.engine.weight_service``) instead of parsing
it; the connection is the import's lease. ``--tool-parser`` and
``--reasoning-parser`` name the card's parsers (parsers/; gpt-oss presets
default to ``harmony`` / ``gpt_oss``); an unknown name fails at start.

The engine publishes its KV events and load (kv_router/publisher.py) on
the runtime's event plane, for a frontend in ``--router-mode kv`` or the
standalone router (``python -m dynamo_tpu_torch.router``): with
``--event-plane zmq`` (the port's own broker) across processes. A LoRA
worker's load reports carry its adapter keys, republished at once after
each adapter load or unload.

Health and status, as the reference worker wires them: step telemetry
(engine/telemetry.py) on the runtime's metrics, the ``cost_model_drift``
detector fed each step's measured time against ops/costs.py's floor (the
card's memory rate, the model's weight bytes, the engine's measured
dispatch round trip; N passes for a horizon of N steps), the SLO ledger
and the attribution aggregates fed by the engine, an engine watchdog that
deregisters the model when the loop crashes, a canary that pings the
generate endpoint over the request plane, and with ``--system-port P``
(0: any free port; ``DTPU_SYSTEM_PORT``) a status server
(runtime/health.py: /health, /live, /metrics, /metadata, /v1/loras,
/debug/requests, /debug/slo, /debug/worker, POST /drain) whose address
the worker prints as ``TORCH_STATUS_ADDRESS host:port`` and advertises as
``status_address`` in its discovery metadata, for the frontend's
``/debug/fleet``. Health events go out on the event plane as
``dtpu.health.<detector>``.

Disaggregation (``--disagg``, engine/transfer.py): ``prefill`` joins the
model's prefill pool (component ``backend_prefill`` for the default
``backend``, model type ``prefill``) and serves its KV pages on a transfer
endpoint; ``decode`` serves generation and imports the pages its requests'
``kv_transfer`` plans name (and serves its own pages to peers too). Both
print ``KV_TRANSFER at <address>`` and advertise ``transfer_address`` and
``kv_wire`` (``DTPU_KV_WIRE``, default ``inline``) in their discovery
metadata; the card carries ``kv_bytes_per_block``. Two workers on one card
move pages through the card's memory (CUDA IPC) unless
``DTPU_DEVICE_TRANSFER=0``. The per-wire bandwidth EWMA
(``dtpu_kv_wire_bandwidth_bytes_per_s``) and the transfer fallbacks
(``dtpu_kv_transfer_fallbacks_total``) are on /metrics, the EWMA also in
``/debug/worker``'s ``bandwidth`` section and the transfer plane's counters
in its ``transfer`` section; each pull's EWMA feeds the ``wire_collapse``
detector.

KVBM: ``--kvbm-host-gb`` / ``--kvbm-disk-gb`` give the engine its G2 / G3
tiers, and ``--kvbm-remote HOST:PORT`` (``DTPU_KVBM_REMOTE``) writes sealed
blocks through to a G4 block store (``python -m dynamo_tpu_torch.kvbm``)
and onboards from it. With ``DTPU_GLOBAL_KV=1`` a KVBM worker serves the
transfer endpoint in aggregated mode too, advertises its G2/G3 blocks in
the global KV directory (kvbm/directory.py) under a lease of its own,
revoked at shutdown, and reports them in ``/debug/worker``'s ``global_kv``
section (published entries, fetch leases open, dedupe skips).

Planned reclaims (engine/drain.py, engine/checkpoint.py): with
``DTPU_CKPT_DIR`` the worker restores the sealed KV pages of the
checkpoint there before it serves (``CHECKPOINT_RESTORE mode=... blocks=...
windows=... scatter=... seconds=...``; its stored KV events go out at
once, before any request; the mode on the
``dtpu_checkpoint_restore_mode`` gauge and in ``/debug/worker``'s
``restore_mode`` and ``restore``), and ``POST /drain`` (``{"deadline_s":
30}``) runs the drain: discovery says ``state=draining``, the requests in
flight finish inside the deadline, the sealed pages go to a checkpoint in
``DTPU_CKPT_DIR``, and the worker exits (code 0). ``/debug/worker``'s
``drain`` section says whether a drain runs and how the last one went. A
worker whose engine loop dies serves its transfer endpoint until no pull
came for a few seconds (at most ``--graceful-timeout``): the requests that
died carry evacuation plans that point at its host tier. With
``DTPU_FAULTS_ADMIN=1`` the status server also takes ``POST /debug/faults``
(``{"spec": "engine.step:fail@1"}``): the spec's points are armed anew, their
call counts from 0 (runtime/faults.py), for drills on a running worker.

Beside ``generate`` the worker serves ``clear_kv_blocks`` under the same
instance id (llm/serve.py ``serve_clear_endpoint``; the frontend's ``POST
/clear_kv_blocks`` fans out to it). A vision preset (``--preset tiny-vl``)
publishes its tower's ``image_tokens``, ``image_size`` and
``image_token_id`` on the card, so the frontend decodes and places image
parts (llm/media.py). ``DTPU_REQUEST_PLANE=http`` serves the endpoints on
the HTTP request plane (runtime/request_plane/http.py) instead of TCP, and
``--store etcd --store-path http://host:2379`` discovers through etcd.

Tensor parallelism (``--tp N``, the dense llama family): the worker is
the leader of a TP group of N processes on this host. It starts N-1
follower processes of this module (the same flags plus ``--multihost
coord:port,N,rank,control:port`` on free ports); each joins the group
(``torch.distributed``: gloo on the CPU, NCCL when every rank has its own
card, gloo on CUDA tensors when ranks share one, printed as
``TP_GROUP ...``), holds its shard of the weights (``--num-layers`` cuts
a preset's depth) and replays the leader's device ops; only the leader
serves, registers and publishes. Ranks that share a card run their
horizons eagerly (``cuda_graphs`` off, printed). A follower that dies
takes the worker out of discovery (the engine is marked unhealthy and
the watchdog deregisters it); at exit each follower prints
``TORCH_TP_FOLLOWER_EXIT {json}`` (its launches, steps, collectives and a
digest of the tokens its ops sampled) and the leader's exit report
carries its own. Guided decoding is off by default at ``--tp`` > 1, and
the combinations a TP group does not serve yet (ROADMAP.md Queue 1 item
6: ``--disagg``, KVBM tiers, ``DTPU_CKPT_DIR`` and ``POST /drain``,
spec decoding, LoRA, processors, a weight owner) are refused at start.

Prints ``TORCH_ENGINE_READY <model> device=<device>`` once it serves. On
SIGTERM or SIGINT it deletes its instance and card keys at once, drains the
requests in flight for up to ``--graceful-timeout`` seconds, then prints
(a drained worker too) ``TORCH_ENGINE_EXIT {json}``: each kernel's
launches since the process started, as ``ops/_build`` counts them (the
engine's build and graph
captures, and CUDA-graph replays, included), the engine's
steps by kind, its busy slots and pinned KV blocks (both 0 once every
request, a cancelled one too, has freed its slot), its prefix cache
(``block_set_view`` of the allocator's hashes, which a KV router's view of
this worker equals once both are idle), the KV events it published by
kind, the transfer plane's counters, and the drain's and restore's
summaries.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import json
import os
import signal
import statistics
import sys
from typing import List, Optional

from ..kv_router import KvEventPublisher, WorkerMetricsPublisher
from ..kv_router.protocols import block_set_view
from ..llm.model_card import (
    MODEL_TYPE_CHAT,
    MODEL_TYPE_COMPLETIONS,
    MODEL_TYPE_EMBEDDING,
    MODEL_TYPE_PREFILL,
    ModelDeploymentCard,
    ModelRuntimeConfig,
)
from ..kvbm.directory import GlobalKvDirectory, directory_enabled
from ..llm.serve import register_llm, serve_clear_endpoint
from ..models.registry import PRESETS, is_gptoss
from ..parsers import get_reasoning_parser, get_tool_parser
from ..runtime.component import new_instance_id
from ..runtime import metrics as M
from ..runtime.config import (
    ENV_CKPT_DIR,
    ENV_SYSTEM_PORT,
    ENV_KVBM_DISK_CACHE_GB,
    ENV_KVBM_DISK_PATH,
    ENV_KVBM_HOST_CACHE_GB,
    ENV_KVBM_REMOTE,
    ENV_MIGRATION_LIMIT,
    ENV_NAMESPACE,
    ENV_WEIGHT_SERVICE,
    RuntimeConfig,
    env_bool,
    env_float,
    env_int,
    env_str,
)
from ..runtime.distributed import DistributedRuntime
from ..ops.costs import predict_step_seconds
from ..runtime.attribution import get_attribution
from ..runtime.bandwidth import get_bandwidth_estimator
from ..runtime.health import EndpointCanary, HealthState, StatusServer, get_health_monitor
from ..runtime.logging import get_logger, init_logging
from ..runtime.slo import debug_slo_payload, get_slo_accountant
from ..runtime.tracing import get_tracer
from .checkpoint import restore_engine, weights_ref_for
from .drain import DrainCoordinator
from ..runtime.multihost import reap
from .monitor import EngineWatchdog
from .telemetry import EngineTelemetry

READY = "TORCH_ENGINE_READY"
EXIT = "TORCH_ENGINE_EXIT"
FOLLOWER_EXIT = "TORCH_TP_FOLLOWER_EXIT"
STATUS = "TORCH_STATUS_ADDRESS"
# the drift predictor's memory rate: the H100's HBM3, as PERF.md's bounds
HBM_BYTES_S = 3.35e12
# a worker whose loop died serves evacuation pulls until its transfer
# endpoint has been idle this long (at most --graceful-timeout)
EVACUATION_IDLE_S = 3.0
# DTPU_FAULTS_ADMIN=1: POST /debug/faults arms fault points on a running worker
ENV_FAULTS_ADMIN = "DTPU_FAULTS_ADMIN"


log = get_logger("engine.worker")


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    from ..run import VISION_PRESETS

    presets = sorted(list(PRESETS) + list(VISION_PRESETS))
    p = argparse.ArgumentParser("dynamo_tpu_torch.engine")
    p.add_argument("--model", default="torch-model", help="served model name")
    p.add_argument("--model-path", default=None,
                   help="HF checkpoint directory or hub reference")
    p.add_argument("--preset", default="tiny", choices=presets)
    p.add_argument("--tokenizer", default=None,
                   help="'byte' or a tokenizer directory (default: the checkpoint's "
                        "own; byte for a preset)")
    p.add_argument("--tool-parser", default=None,
                   help="streaming tool-call dialect for this model's card "
                        "(parsers/tool_calls.py registry); default: harmony "
                        "for gpt-oss presets, else none")
    p.add_argument("--reasoning-parser", default=None,
                   help="reasoning-block parser for the card "
                        "(e.g. deepseek_r1, qwen3, gpt_oss; "
                        "parsers/reasoning.py registry); default: gpt_oss "
                        "for gpt-oss presets, else none")
    p.add_argument("--namespace", default=env_str(ENV_NAMESPACE, "dynamo"))
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--store", default=None, help="mem|file|tcp|etcd (default: DTPU_STORE)")
    p.add_argument("--store-path", default=None)
    p.add_argument("--event-plane", default=None, help="zmq|inproc (default: DTPU_EVENT_PLANE)")
    p.add_argument("--system-port", "--status-port", type=int,
                   default=env_int(ENV_SYSTEM_PORT, -1),
                   help="status server port (/health /live /metrics /metadata /debug/*); "
                        "0 = any free port, -1 = none (default: DTPU_SYSTEM_PORT)")
    p.add_argument("--graceful-timeout", type=float, default=10.0,
                   help="seconds to wait for in-flight requests on shutdown")
    p.add_argument("--device", default=None, help="default: cuda; 'cpu' for the CPU")
    p.add_argument("--seed", type=int, default=0, help="random-weight seed")
    p.add_argument("--num-blocks", type=int, default=2048)
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--kv-dtype", default="auto", choices=("auto", "model", "int8"),
                   help="paged-KV storage: int8 pages with per-block scales; auto "
                        "defers to DTPU_KV_DTYPE (default: the model dtype)")
    p.add_argument("--max-batch-size", type=int, default=8)
    p.add_argument("--max-context", type=int, default=2048)
    p.add_argument("--prefill-chunk", type=int, default=2048,
                   help="largest single prefill dispatch; longer prompts chunk")
    p.add_argument("--migration-limit", type=int, default=env_int(ENV_MIGRATION_LIMIT, 0))
    p.add_argument("--kvbm-host-gb", type=float,
                   default=env_float(ENV_KVBM_HOST_CACHE_GB, 0.0),
                   help="host memory KV tier size (G2); 0 disables KVBM")
    p.add_argument("--kvbm-disk-gb", type=float,
                   default=env_float(ENV_KVBM_DISK_CACHE_GB, 0.0),
                   help="disk KV tier size (G3)")
    p.add_argument("--kvbm-disk-path", default=env_str(ENV_KVBM_DISK_PATH, "") or None)
    p.add_argument("--kvbm-remote", default=env_str(ENV_KVBM_REMOTE, "") or None,
                   help="G4 remote block store host:port (python -m dynamo_tpu_torch.kvbm): "
                        "sealed blocks write through to it and onboard from it")
    p.add_argument("--decode-steps", type=int, default=None,
                   help="decode steps per dispatch (default: auto-tuned)")
    p.add_argument("--decode-pipeline", type=int, default=None,
                   help="decode horizons in flight (default: auto-tuned)")
    p.add_argument("--no-warm-cache", action="store_true",
                   help="parse the checkpoint on every start")
    p.add_argument("--weight-service", default=env_str(ENV_WEIGHT_SERVICE, "") or None,
                   metavar="SOCK",
                   help="unix socket of a weight owner (engine/weight_service.py): import "
                        "--model-path's weights from its shared memory instead of parsing "
                        "the checkpoint (default: DTPU_WEIGHT_SERVICE)")
    p.add_argument("--spec-draft", default=None, choices=presets,
                   help="speculative decoding with a draft of this preset")
    p.add_argument("--spec-draft-path", default=None,
                   help="speculative decoding with a draft from this checkpoint")
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--guided-max-states", type=int, default=None,
                   help="guided decoding automaton cap; 0 disables guided decoding "
                        "(default: 1024, and 0 at --tp > 1)")
    p.add_argument("--guided-max-classes", type=int, default=320)
    p.add_argument("--logits-processors", default=None,
                   help="named processors to register, e.g. "
                        "'ban=5,7,9;temperature=0.7;norepeat=2.0'")
    p.add_argument("--lora-max-adapters", type=int, default=0,
                   help="multi-LoRA slots; enables the load_lora / unload_lora / "
                        "list_loras endpoints")
    p.add_argument("--lora-rank", type=int, default=16)
    p.add_argument("--disagg", choices=["none", "prefill", "decode"], default="none",
                   help="prefill: join the prefill pool and serve kv_fetch; decode: serve "
                        "decode with remote-KV import (also serves kv_fetch for peers)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: the worker leads a group of this many "
                        "processes on this host (dense llama family)")
    p.add_argument("--multihost", default=None, metavar="COORD:PORT,N,RANK[,CTRL:PORT]",
                   help="this process's place in a TP group (the leader passes it to the "
                        "followers it starts)")
    p.add_argument("--num-layers", type=int, default=None,
                   help="serve a preset's first N layers (random weights at the preset's "
                        "width)")
    args = p.parse_args(argv)
    if args.guided_max_states is None:
        args.guided_max_states = 1024 if args.tp == 1 else 0
    return args


def build_logits_processors(spec: Optional[str]):
    """``--logits-processors`` -> (name, fn) pairs."""
    if not spec:
        return ()
    from ..logits_processing import (
        ban_tokens_processor,
        repetition_window_processor,
        temperature_processor,
    )

    built = []
    for part in spec.split(";"):
        name, _, val = part.strip().partition("=")
        if name == "ban":
            built.append(("ban", ban_tokens_processor([int(t) for t in val.split(",") if t])))
        elif name == "temperature":
            built.append(("temperature", temperature_processor(float(val))))
        elif name == "norepeat":
            built.append(("norepeat", repetition_window_processor(float(val))))
        else:
            raise SystemExit(f"unknown logits processor {name!r}")
    return tuple(built)


def guided_vocab_for(tokenizer_ref: str, max_states: int):
    """(vocab byte forms, eos id) for guided decoding, or None when it is
    off or the tokenizer has no EOS (guided decoding is then disabled)."""
    if max_states <= 0:
        return None
    from ..guided import vocab_bytes_from_tokenizer
    from ..llm.tokenizer import load_tokenizer

    try:
        return vocab_bytes_from_tokenizer(load_tokenizer(tokenizer_ref))
    except ValueError as e:
        print(f"guided decoding disabled: {e}", flush=True)
        return None


def join_tp_group(args: argparse.Namespace, argv: Optional[List[str]] = None,
                  stdout=None):
    """(multihost context, follower processes) of a ``--tp`` > 1 worker,
    (None, []) at ``--tp 1``. Without ``--multihost`` this process is the
    leader of a group on this host and starts its N-1 followers (this
    module, ``argv`` plus their specs; their output to ``stdout``, a file,
    or this process's); either way it joins the group,
    opens the control channel, and points ``args.device`` at its rank's
    device. Refuses, at ``--tp`` > 1, the worker's paths a group does not
    serve yet."""
    from ..parallel.mesh import QUEUE
    from ..runtime.multihost import join_group

    if args.tp == 1:
        if args.multihost:
            raise SystemExit("--multihost is a rank of a --tp > 1 group")
        return None, []
    refused = [flag for flag, on in (
        ("--disagg", args.disagg != "none"),
        ("--kvbm-host-gb/--kvbm-disk-gb/--kvbm-remote",
         args.kvbm_host_gb > 0 or args.kvbm_disk_gb > 0 or bool(args.kvbm_remote)),
        (ENV_CKPT_DIR + " (drain and checkpoint)", bool(env_str(ENV_CKPT_DIR, ""))),
        ("--weight-service", bool(args.weight_service and args.model_path)),
    ) if on]
    if refused:
        raise ValueError(f"--tp {args.tp} does not serve {', '.join(refused)} yet ({QUEUE})")
    mh, device, followers = join_group(args.tp, args.multihost, "dynamo_tpu_torch.engine",
                                       list(sys.argv[1:] if argv is None else argv),
                                       args.device, stdout)
    args.device = str(device)
    log.info("tp rank %d of %d on %s (pid %d)", mh.spec.process_id, args.tp, device,
             os.getpid())
    return mh, followers


def follow(engine, mh) -> dict:
    """A follower's life: replay the leader's ops until it stops the group
    (or its channel closes: the leader died), then leave the group.
    Returns its exit report."""
    try:
        engine.follow()
    except ConnectionError as e:
        log.error("tp follower %d: %s", mh.spec.process_id, e)
    report = {"rank": mh.spec.process_id, "launches": kernel_launches(),
              "steps": dict(engine.step_counts), "collectives": dict(mh.comm.counts),
              "sampled": engine.sampled_digest()}
    mh.close()
    mh.shutdown()
    return report


def build_worker_engine(args: argparse.Namespace, multihost=None):
    """(engine, tokenizer reference) from the worker's flags; with
    ``multihost`` (``join_tp_group``), this rank's engine of the group."""
    from ..device import resolve_device
    from ..llm.hub import resolve_model_path
    from ..run import build_engine

    if multihost is None:
        resolve_device(args.device)
    bs = args.block_size
    args.max_context = -(-args.max_context // bs) * bs
    out = args.model_path or args.preset
    tok_ref = args.tokenizer or (resolve_model_path(args.model_path) if args.model_path
                                 else "byte")
    vocab = guided_vocab_for(tok_ref, args.guided_max_states)
    engine = build_engine(
        out, args.device, args.max_context, args.seed, kv_dtype=args.kv_dtype,
        kvbm_host_gb=args.kvbm_host_gb, kvbm_disk_gb=args.kvbm_disk_gb,
        kvbm_disk_path=args.kvbm_disk_path, kvbm_remote=args.kvbm_remote,
        decode_steps=args.decode_steps,
        decode_pipeline=args.decode_pipeline, spec_draft=args.spec_draft,
        spec_k=args.spec_k, spec_draft_path=args.spec_draft_path,
        warm_cache=not args.no_warm_cache, num_blocks=args.num_blocks, block_size=bs,
        max_batch_size=args.max_batch_size, prefill_chunk=-(-args.prefill_chunk // bs) * bs,
        guided_vocab=vocab, guided_max_states=args.guided_max_states if vocab else 0,
        guided_max_classes=args.guided_max_classes,
        logits_processors=build_logits_processors(args.logits_processors),
        lora_max_adapters=args.lora_max_adapters, lora_rank=args.lora_rank,
        weight_service=args.weight_service if args.model_path else None,
        tp=args.tp, multihost=multihost, num_layers=args.num_layers,
    )
    return engine, tok_ref


async def serve_lora_endpoints(runtime: DistributedRuntime, namespace: str, component: str,
                               engines) -> list:
    """The load_lora / unload_lora / list_loras endpoints beside generate,
    as the reference worker serves them: a load fetches the adapter (a
    PEFT directory or an .npz, by path or file:// URI) into the local
    adapter cache and writes it into every engine's tables."""
    from ..lora import LoRACache, LocalLoRASource, load_adapter

    cache, source = LoRACache(), LocalLoRASource()

    async def handle_load(request, context):
        name, uri = request["name"], request["uri"]

        def work():
            weights, alpha = load_adapter(source.fetch(uri, cache))
            return [e.lora.load(name, weights, alpha) for e in engines]

        try:
            slots = await asyncio.get_running_loop().run_in_executor(None, work)
        except Exception as e:
            yield {"ok": False, "error": str(e)}
            return
        await publish_keys()
        yield {"ok": True, "name": name, "slot": slots[0]}

    async def handle_unload(request, context):
        ok = all([e.lora.unload(request["name"]) for e in engines])
        await publish_keys()
        yield {"ok": ok}

    async def publish_keys():
        # the KV router hashes an adapter request with the load's key: it
        # must have the new one before the adapter's next request
        for e in engines:
            await e.publish_load()

    async def handle_list(request, context):
        yield {"adapters": engines[0].lora.list_adapters()}

    comp = runtime.namespace(namespace).component(component)
    return [await comp.endpoint(name).serve(handler)
            for name, handler in (("load_lora", handle_load),
                                  ("unload_lora", handle_unload),
                                  ("list_loras", handle_list))]


def kernel_launches() -> dict:
    """Each kernel wrapper's launches since start, and under "replayed"
    the share CUDA-graph replays made."""
    from ..ops import block_copy as bc
    from ..ops import cuda_attention, cuda_mla, cuda_prefill, cuda_unified

    counters = {
        "decode": cuda_attention.KERNEL, "decode_int8": cuda_attention.KERNEL_INT8,
        "flash_extend": cuda_prefill.KERNEL, "flash_extend_int8": cuda_prefill.KERNEL_INT8,
        "unified": cuda_unified.KERNEL, "unified_int8": cuda_unified.KERNEL_INT8,
        "merge": cuda_unified.MERGE, "latent_narrow": cuda_mla.NARROW,
        "latent_wide": cuda_mla.WIDE, "gather": bc.GATHER, "scatter": bc.SCATTER,
        "copy": bc.COPY,
    }
    out = {name: k.launches for name, k in counters.items()}
    out["replayed"] = {name: k.replayed for name, k in counters.items()}
    return out


def metric_values(metrics, prefix: str) -> dict:
    """The values of ``metrics``' series named ``prefix...``, by name (the
    sum over their labels)."""
    out: dict = {}
    for line in metrics.expose().decode().splitlines():
        if line.startswith(prefix):
            name, value = line.split("{", 1)[0].split(" ", 1)[0], line.rsplit(" ", 1)[1]
            out[name] = out.get(name, 0.0) + float(value)
    return out


def step_predictor(engine, args):
    """StepStats -> the roofline floor of the step's forward passes
    (ops/costs.py): every active row at the occupancy-mean context, its
    pages and one stream of the model's weights over the card's memory
    rate, plus the engine's measured dispatch round trip, times the passes
    (a horizon of N decode steps is N). A rank of a TP group is priced by
    its own share: ``engine.mcfg`` is its local config (its heads and kv
    heads' pages) and its parameters are its shards."""
    from .engine import param_bytes

    m = engine.mcfg
    weights = param_bytes(engine.params)
    dispatch_s = float(engine.schedule.get("rtt_s", 0.0))
    kv_heads = getattr(m, "num_kv_heads", 1)
    head_dim = getattr(m, "head_dim", 0) or getattr(m, "kv_lora_rank", 0)
    item = 1 if engine.kv_quantized else 2

    def predict(s) -> float:
        occ = max(s.batch_occupancy, 1)
        mean_len = max(s.kv_active_blocks * args.block_size // occ, 1)
        q = max(s.tokens // occ, 1) if s.phase != "decode" else 1
        one = predict_step_seconds(
            [(q, mean_len)] * occ, block_size=args.block_size, kv_heads=kv_heads,
            num_heads=m.num_heads, head_dim=head_dim, layers=m.num_layers,
            hbm_bytes_s=HBM_BYTES_S, dispatch_s=dispatch_s, weight_bytes=weights,
            kv_itemsize=item, quantized=engine.kv_quantized)
        return one * max(s.passes, 1)

    return predict


async def serve_status(args, runtime, engine, served, instance_id, telemetry, monitor,
                       health, canary, drift, drain: Optional[DrainCoordinator] = None,
                       restored: Optional[dict] = None):
    """The status server (``POST /drain`` runs ``drain`` when given) and its
    ``/debug/worker`` document; advertises its address in the discovery
    metadata. Returns the server. ``drift``: {phase: recent measured /
    predicted step ratios}; ``restored``: the start's restore, or None."""
    gauges = {name: runtime.metrics.gauge(f"dtpu_engine_{name}", doc) for name, doc in (
        ("running_seqs", "active sequences"), ("waiting_seqs", "queued sequences"),
        ("free_blocks", "free KV blocks"), ("cached_blocks", "prefix-cached KV blocks"))}

    def refresh_gauges() -> None:
        snap = engine.snapshot()
        gauges["running_seqs"].set(snap["running"])
        gauges["waiting_seqs"].set(snap["waiting"])
        gauges["free_blocks"].set(snap["free_blocks"])
        gauges["cached_blocks"].set(snap["cached_blocks"])
        # the rolling attainment / burn gauges follow the scrape clock
        get_slo_accountant().export_metrics()

    def worker_snapshot() -> dict:
        """What the frontend's /debug/fleet merges from this worker: host
        counters only, with the global KV directory's section when the
        worker advertises in it and the restore's when it restored."""
        snap = engine.snapshot()
        doc = {
            "instance_id": f"{instance_id:016x}", "model": args.model, "tp": engine.tp, "dp": 1,
            "engine": snap, "telemetry": [telemetry.snapshot()],
            "slo": debug_slo_payload(get_slo_accountant()),
            "attribution": get_attribution().snapshot(),
            "bandwidth": get_bandwidth_estimator().snapshot(),
            "transfer": engine.transfer_snapshot(),
            "health": monitor.snapshot(),
            "drift": {phase: {"steps": len(r), "median_ratio": statistics.median(r)}
                      for phase, r in sorted(drift.items()) if r},
            "kv": {"active_blocks": snap["active_blocks"], "free_blocks": snap["free_blocks"],
                   "total_blocks": engine.cfg.num_blocks,
                   "cached_blocks": snap["cached_blocks"]},
        }
        if drain is not None:
            doc["drain"] = {"draining": drain.ledger.draining, "last": drain.last}
        if restored is not None:
            doc["restore_mode"] = restored["mode"]
            doc["restore"] = {k: v for k, v in restored.items() if k != "queue"}
        directory = engine.kv_directory
        if directory is not None:
            doc["global_kv"] = {"published": directory.published_count,
                                "inflight_fetches": directory.inflight_fetches,
                                "dedupe_skipped": directory.dedupe_skipped}
        return doc

    server = StatusServer(
        health, metrics_scope=runtime.metrics, pre_expose=refresh_gauges,
        metadata_fn=lambda: {"model": args.model, "instance_id": f"{instance_id:016x}",
                             "tp": engine.tp, "engine": engine.snapshot(),
                             "canary_rtt_s": canary.last_rtt},
        port=args.system_port,
        loras_fn=(engine.lora.list_adapters if engine.lora is not None else None),
        drain_fn=drain.begin if drain is not None else None,
        worker_snapshot_fn=worker_snapshot,
    )
    if env_bool(ENV_FAULTS_ADMIN):
        server.server.add_route("POST", "/debug/faults", arm_faults)
    await server.start()
    address = f"{runtime.config.host_ip}:{server.port}"
    await served.update_metadata({"status_address": address})
    print(f"{STATUS} {address}", flush=True)
    return server


async def arm_faults(request):
    """``POST /debug/faults`` ``{"spec": "point:action[@n]; ..."}``: each
    point the spec names is disarmed (its call count back to 0) and armed
    with the spec's rules; answers with the points' call counts."""
    from ..llm.http.server import json_response
    from ..runtime.faults import FAULTS, parse_faults

    try:
        rules = parse_faults(str((request.json() or {}).get("spec", "")))
    except (ValueError, AttributeError) as e:
        return json_response({"error": str(e)}, status=400)
    for point in {r.point for r in rules}:
        FAULTS.disarm(point)
    for r in rules:
        FAULTS.arm_rule(r)
    return json_response({"armed": [f"{r.point}:{r.action}" for r in rules]})


def health_publisher(runtime: DistributedRuntime, loop: asyncio.AbstractEventLoop):
    """A health-monitor subscriber that publishes each event on the event
    plane (``dtpu.health.<detector>``) for subscribers that do not scrape.
    A detector may fire off the loop thread. Each publish is a task of the
    runtime's tracker, so ``runtime.shutdown()`` drains the events still in
    flight before it closes the event plane; one that fires after the drain
    began is dropped."""

    def spawn(topic: str, payload: bytes) -> None:
        try:
            runtime.tasks.spawn(lambda: runtime.event_plane.publish(topic, payload))
        except RuntimeError:
            log.debug("health event %s after shutdown began: dropped", topic)

    def publish(ev) -> None:
        try:
            loop.call_soon_threadsafe(spawn, f"dtpu.health.{ev.detector}",
                                      json.dumps(ev.to_dict()).encode())
        except RuntimeError:
            pass  # the loop closed during shutdown

    return publish


def worker_card(args: argparse.Namespace, engine, tok_ref: str, tool_parser: Optional[str],
                reasoning_parser: Optional[str]) -> ModelDeploymentCard:
    """The model card this worker publishes. A vision preset's tower
    (``run.VISION_PRESETS``, e.g. ``tiny-vl``) puts its image fields on it:
    the frontend's preprocessor decodes each image to ``image_size`` and
    places ``image_tokens`` placeholders of ``image_token_id``."""
    vcfg = engine.cfg.vision
    component = args.component
    model_type = [MODEL_TYPE_CHAT, MODEL_TYPE_COMPLETIONS, MODEL_TYPE_EMBEDDING]
    if args.disagg == "prefill":
        component = args.component + "_prefill" if args.component == "backend" else args.component
        model_type = [MODEL_TYPE_PREFILL]
    return ModelDeploymentCard(
        name=args.model, namespace=args.namespace, component=component,
        endpoint=args.endpoint, model_type=model_type,
        tokenizer=tok_ref, context_length=args.max_context, kv_block_size=args.block_size,
        migration_limit=args.migration_limit,
        tool_parser=tool_parser, reasoning_parser=reasoning_parser,
        image_tokens=vcfg.num_patches if vcfg is not None else 0,
        image_size=vcfg.image_size if vcfg is not None else 0,
        image_token_id=engine.cfg.image_token_id,
        runtime_config=ModelRuntimeConfig(
            total_kv_blocks=engine.cfg.num_blocks, kv_block_size=args.block_size,
            max_batch_size=args.max_batch_size, max_context_len=args.max_context),
    )


async def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    init_logging()
    # an unknown parser name fails here, before the build (the frontend
    # would only warn and pass text through)
    get_tool_parser(args.tool_parser)
    get_reasoning_parser(args.reasoning_parser)
    # a TP group first (its followers start building at once), then the
    # engine: its build (weights, graph capture) blocks the loop, which
    # must not hold a lease yet
    mh, followers = join_tp_group(args, argv)
    engine, tok_ref = build_worker_engine(args, mh)
    if mh is not None and not mh.is_leader:
        # one write: the leader shares this output
        print(f"{FOLLOWER_EXIT} {json.dumps(follow(engine, mh))}\n", end="", flush=True)
        return
    # gpt-oss: the harmony dialect and its reasoning channels by default
    oss = is_gptoss(engine.mcfg)
    tool_parser = args.tool_parser if args.tool_parser is not None else (
        "harmony" if oss else None)
    reasoning_parser = args.reasoning_parser if args.reasoning_parser is not None else (
        "gpt_oss" if oss else None)
    cfg = RuntimeConfig.from_env(store=args.store, store_path=args.store_path,
                                 event_plane=args.event_plane)
    runtime = await DistributedRuntime(cfg).start()
    instance_id = new_instance_id()
    card = worker_card(args, engine, tok_ref, tool_parser, reasoning_parser)
    # one publisher pair per engine (dp_rank 0: the port has no data
    # parallelism yet), under the card's component (a prefill worker's is
    # its pool's)
    engine.kv_publisher = KvEventPublisher(
        runtime.event_plane, args.namespace, card.component, worker_id=instance_id,
        block_size=args.block_size)
    engine.metrics_publisher = WorkerMetricsPublisher(
        runtime.event_plane, args.namespace, card.component, worker_id=instance_id)
    if args.disagg != "none":
        # before register_llm, which advertises the address: a streamed hop
        # dispatches the decode request before the prefill ends
        addr = await engine.serve_transfer(host=cfg.host_ip)
        print(f"KV_TRANSFER at {addr}", flush=True)
    directory = None
    if engine.kvbm is not None and directory_enabled():
        # fleet-wide KV reuse (kvbm/directory.py): advertise the sealed
        # blocks of the host and disk tiers under a store lease and serve
        # peers' pulls on the transfer endpoint, in aggregated mode too
        if engine.transfer_address is None:
            addr = await engine.serve_transfer(host=cfg.host_ip)
            print(f"KV_TRANSFER at {addr}", flush=True)
        directory = GlobalKvDirectory(runtime.store, f"worker/{instance_id}",
                                      address=engine.transfer_address,
                                      metrics=runtime.metrics)
        await directory.start()
        engine.kv_directory = directory
    # step telemetry on the runtime's metrics, under the component's labels,
    # and the drift detector fed from the same hook
    scope = runtime.metrics.child(dtpu_namespace=args.namespace,
                                  dtpu_component=card.component,
                                  dtpu_endpoint=args.endpoint)
    telemetry = EngineTelemetry(scope.child(dp_rank="0"))
    monitor = get_health_monitor()
    monitor.bind_metrics(scope)
    predict = step_predictor(engine, args)
    subject = f"worker/{instance_id:016x}/dp0"
    # the last measured / predicted ratios by phase, for /debug/worker
    drift: dict = {}

    def on_step(s) -> None:
        telemetry.on_step(s)
        try:
            predicted = predict(s)
            drift.setdefault(s.phase, collections.deque(maxlen=256)).append(
                s.duration_s / predicted)
            monitor.observe_step(subject, s.duration_s, predicted, phase=s.phase)
        except Exception:
            log.exception("drift detector failed")  # never takes the loop down

    engine.stats_hook = on_step
    # the per-wire transfer bandwidth EWMA and the transfer fallbacks on
    # this worker's /metrics (the decode side of a pair observes pulls)
    from .transfer import transfer_stats

    get_bandwidth_estimator().attach_metrics(scope)
    transfer_stats.attach_metrics(scope)
    # the engine feeds the process's SLO ledger; its goodput and
    # attainment / burn gauges go on this worker's /metrics
    get_slo_accountant().bind_metrics(scope)
    served = await register_llm(runtime, engine, card, instance_id=instance_id)
    clear_served = await serve_clear_endpoint(runtime, args.namespace, card.component,
                                              [engine], served.instance_id)
    lora_served = []
    if engine.lora is not None:
        lora_served = await serve_lora_endpoints(runtime, args.namespace, card.component,
                                                 [engine])
    stop = asyncio.Event()
    health = HealthState()
    # planned reclaims: the warm state a drain left in DTPU_CKPT_DIR first,
    # then the coordinator that POST /drain runs (it ends the process)
    ckpt_dir = env_str(ENV_CKPT_DIR, "") or None
    restored = None
    if ckpt_dir:
        scatters = kernel_launches()["scatter"]
        restored = await restore_engine(engine, ckpt_dir)
        restored["scatter"] = kernel_launches()["scatter"] - scatters
        # the restored blocks go to KV routers now, not at the loop's first
        # tick: a follow-up is routed to them before any request arrives
        await engine._publish_events()
        scope.gauge(M.CHECKPOINT_RESTORE_MODE, "1 for the restore mode this worker booted with",
                    extra_labels=("mode",)).set(1, mode=restored["mode"])
        print(f"CHECKPOINT_RESTORE mode={restored['mode']} blocks={restored['blocks']} "
              f"windows={restored['windows']} scatter={restored['scatter']} "
              f"seconds={restored['seconds']:.3f}", flush=True)
    # (a TP group drains nowhere yet: no POST /drain)
    drain = None if mh is not None else DrainCoordinator(
        engine, served, ckpt_dir=ckpt_dir,
        weights_ref=weights_ref_for(args.model_path or args.preset, engine.mcfg),
        metrics_scope=scope, on_drained=stop.set)

    async def on_down() -> None:
        stop.set()   # the watchdog deregistered: exit, so a supervisor restarts

    watchdog = EngineWatchdog(engine, [served], state=health, on_down=on_down).start()
    if mh is not None:
        # a dead follower leaves the group unusable: the engine is marked
        # unhealthy, and the watchdog takes the worker out of discovery
        def on_follower_death() -> None:
            engine.healthy = False

        mh.watch_followers(on_follower_death)
    canary = EndpointCanary({f"{card.component}/{card.endpoint}": served.address},
                            state=health).start()
    status_server = None
    if args.system_port >= 0:
        status_server = await serve_status(args, runtime, engine, served, instance_id,
                                           telemetry, monitor, health, canary, drift, drain,
                                           restored)
    loop = asyncio.get_running_loop()
    health_sub = monitor.subscribe(health_publisher(runtime, loop))
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    print(f"{READY} {args.model} device={engine.device}", flush=True)
    await stop.wait()
    if watchdog.fired and engine._kv_transfer_srv is not None:
        # the requests that died with the loop carry evacuation plans that
        # point at this worker's host tier: serve their pulls first
        await engine._kv_transfer_srv.wait_idle(EVACUATION_IDLE_S, args.graceful_timeout)
    # graceful drain: deregister first (discovery stops routing here), then
    # the request server waits out in-flight streams before closing
    await watchdog.stop()
    await canary.stop()
    health_sub.close()
    if status_server is not None:
        await status_server.stop()
    if not watchdog.fired:
        await served.stop(graceful_timeout_s=args.graceful_timeout)
    for s in lora_served + [clear_served]:
        await s.stop()
    engine.stop()
    if directory is not None:
        # revoke the lease: every advertisement of this worker goes at once
        await directory.close()
    await runtime.shutdown()
    get_tracer().shutdown()
    if engine.weight_lease is not None:
        engine.weight_lease.close()
    tp = None
    if mh is not None:
        # engine.stop() told the followers to stop: wait for them
        codes = reap(followers, args.graceful_timeout + 20.0)
        tp = {"rank": 0, "collectives": dict(mh.comm.counts),
              "sampled": engine.sampled_digest(), "follower_exit_codes": codes}
        mh.shutdown()
    report = {"launches": kernel_launches(), "steps": dict(engine.step_counts),
              "drain": None if drain is None else drain.last,
              "busy_slots": sum(s is not None for s in engine._slots),
              "active_blocks": engine.allocator.active_blocks,
              "worker_id": f"{instance_id:016x}",
              "prefix_cache": block_set_view(engine.allocator._by_hash),
              "kv_events": dict(engine.kv_publisher.counts),
              "transfer": engine.transfer_snapshot(),
              "drain_metrics": metric_values(runtime.metrics, "dtpu_drain_"),
              "restore": ({k: v for k, v in restored.items() if k != "queue"}
                          if restored is not None else None),
              "tp": tp}
    print(f"{EXIT} {json.dumps(report)}", flush=True)


if __name__ == "__main__":
    asyncio.run(main())
