"""TorchEngine: continuous-batching paged-KV serving engine on PyTorch/CUDA.

Counterpart of the reference's engine/engine.py ``TpuEngine``, for the
llama, gemma, gpt-oss, Qwen3-MoE and DeepSeek (MLA) families on one GPU
(models/registry.py picks the family's functions):

- the paged KV cache lives on the device as ``[num_blocks, block_size,
  kv_heads, head_dim]`` per layer; block 0 is scratch;
- device-side prefix-cache reuse: the host ``BlockAllocator``
  content-addresses sealed blocks by chained sequence hash; admission pins
  the longest cached prefix and prefill feeds only the uncached suffix;
- chunked, bucketed prefill: one bounded chunk per loop tick (so resident
  decodes keep moving), padded to a bucket with the reference's conventions
  (pad positions at ``max_context - 1``, pad rows writing scratch block 0);
- the decode horizon (``decode_steps`` > 1, ``_decode_multi``): several
  decode steps per dispatch on device tensors only, each step's sampled
  token fed back on the device, the results read back once per horizon as
  one packed ``[N, B, 2 + 2K]`` array; up to ``decode_pipeline`` horizons
  in flight, each chained on the last one's device carry; stop conditions
  applied on the host afterwards (the tokens after a stop are a discarded
  speculative tail). On CUDA each horizon is one replay of a CUDA graph
  captured at engine start (engine/graphs.py). ``autotune_decode_schedule``
  picks both knobs when they are None. A tick with requests waiting, or
  with no pages to book a horizon, runs ONE eager decode step instead;
- the fused mixed step: when a prefill chunk and resident decodes coexist,
  ONE forward serves both, with the chunk as row 0 and the decode slots as
  rows 1..B of one unified ragged attention launch;
- sampling on the device (only token ids, logprobs and top-logprob rows
  come back to the host);
- the int8 paged cache (``kv_dtype="int8"``, ops/quant.py): int8 pages plus
  f32 ``[num_blocks, kv_heads]`` scale rows per layer, quantized on write,
  read by the int8 forms of the three attention kernels;
- KVBM (``kvbm=KvbmTiers(...)``, kvbm/pool.py): sealed blocks are gathered
  off the device by the block-copy kernel, one launch per offload batch
  for every layer, and written through to the host (G2) and disk (G3)
  tiers and the shared G4 remote store (kvbm/remote.py) on an offload
  thread; a prompt whose prefix missed the device cache onboards it from
  the tiers before admission, by one scatter launch of the block-copy
  kernel;
- fleet-wide KV reuse (``kv_directory``, kvbm/directory.py): every tick
  advertises the blocks newly offloaded to a local tier in the global KV
  directory and withdraws the ones no tier holds any more; a request whose
  ``kv_transfer`` plan says ``tier`` pulls the planned blocks from the
  holder's G2/G3 over the tier stream (engine/transfer.py, one scatter
  launch a window) under a directory fetch lease, committed on any import
  and aborted (a recompute) otherwise;
- KV events (``kv_publisher=`` / ``metrics_publisher=``, kv_router/
  publisher.py): every loop tick drains the allocator's stored / removed
  events and publishes them and the load (with a LoRA engine's adapter
  keys, which a KV router salts an adapter request's hashes with) for the
  frontend's KV router;
- vision prompts (``vision=VisionConfig(...)``, every family but
  Qwen3-MoE, as the reference): the images
  of a request's ``images`` annotation go through the vision tower
  (models/vision.py, plain PyTorch as in the reference) and the encoder
  cache (llm/encoder_cache.py), and each prefill chunk splices their patch
  features over the prompt's placeholder runs (``image_token_id``) before
  the first layer (a Gemma forward scales them as its token embeddings),
  and attends through the family's prefill kernel; such prompts never enter or match the prefix cache
  (``no_cache``), and a vision engine runs no fused mixed step, as the
  reference's does not;
- speculative decoding (``spec_draft=<config>``, a main of any family, a
  draft of the dense llama, Qwen3-MoE or Gemma family sharing its
  vocabulary): a draft model with a shadow paged cache, addressed by the main
  cache's block tables, drafts ``spec_k`` greedy tokens per round through
  the decode kernel (a Gemma draft: the unified kernel's q_len = 1 rows
  with its attributes), and ONE main forward verifies the ``spec_k + 1``
  candidates as ``q_len = spec_k + 1`` rows of the unified kernel with
  each layer's attributes, or of the latent kernel on an MLA main
  (``_spec_multi``); a dispatch whose rows are all greedy with no
  penalties or logprobs runs a spec horizon (one CUDA-graph replay on
  CUDA) in place of the normal one, and streams exactly its tokens;
- logits processors (``logits_processors``, logits_processing/): a request
  opts into processors registered at build by name (annotation
  ``logits_processors``); guided decoding (``guided_max_states`` and the
  constructor's ``guided_vocab``, guided/): a request's ``sampling.guided``
  grammar compiles to token tables held per slot on the device, which
  mask its logits in every step kind, its FSM state riding the horizon's
  carry; multi-LoRA (``lora_max_adapters``, lora/, dense llama family): a
  request names an adapter (annotation ``lora``) loaded into the engine's
  in-place tables (``engine.lora.load``), and its block hashes are salted
  with the adapter's load (``LoraAdapterTable.cache_key``), so no adapter
  request reuses KV computed without its weights. In each sampling
  epilogue the order is the reference's: penalties, processors, the
  grammar mask, the sampler; logprobs stay those of the raw logits. On an
  engine with any of them the horizon has a second set of graphs, replayed
  only when a row of the dispatch uses a feature;
- embeddings (a request annotated ``op: embed``): the last token's final
  hidden state, float32, L2-normalised, in one ``BackendOutput``'s
  annotations, as the reference's. The loop serves them between steps,
  never while a horizon is in flight. An input of one prefill bucket runs
  one forward that attends over its own K/V outside the pool; a longer one
  runs as prefill chunks over temporary pages that are never committed or
  offloaded and are released after (``_run_embed``).

Attention runs through the wrappers of the hand-written CUDA kernels
(ops/cuda_attention, cuda_prefill, cuda_unified): on CUDA tensors they
launch the kernels, on CPU tensors (``device="cpu"``, how the tests hold
this engine to ``TpuEngine``) they run the plain PyTorch versions. A layer
that passes attention attributes (gemma's sliding window and softcap,
gpt-oss's window and per-head sinks) is served by the unified kernel in
every step kind, as the reference routes any call with a non-empty
``extra``: a decode step as ``q_len = 1`` rows, a prefill chunk as one
ragged row, and the mixed step as it is. The llama and Qwen3-MoE families
keep their decode and flash-extend kernels. An MLA model (one kv head of
576 latent lanes) is served by the latent kernel (ops/cuda_mla) in every
step kind, in the same ragged form, reading the K cache alone (its V rows,
still written as the reference writes them, equal the K rows' first
kv_lora_rank lanes); its cache holds bf16 only (an int8 cache is refused). The expert FFNs (gpt-oss, Qwen3-MoE, DeepSeek's
routed experts) run as grouped matrix products over the (token, slot)
pairs sorted by expert on the device (models/gptoss.experts_grouped,
models/moe.experts_grouped), inside the horizon's graphs too.

Device work runs on a single executor thread so the asyncio loop that
streams results never blocks behind the GPU; a horizon's readback waits on
a fetch thread.

Tensor parallelism (``tp`` > 1, the dense llama family): the engine is one
rank of a TP group, one process per rank (runtime/multihost.py,
parallel/). Each rank holds its shards of the weights and its kv heads'
pages (``[num_blocks, block_size, kv_heads / tp, head_dim]``), and runs the
attention kernels on its own heads; each layer's row-parallel products are
summed over the ranks (models/llama.py). Every step kind is split into its
host preparation, on the leader (rank 0: the scheduler, the allocator,
the streams, KV events and load), and ONE device op (``_dev_*``, the
admission's table writes included) that the leader broadcasts with its
host arrays and every follower replays in the same order. Sampling is
replicated: every rank samples the same tokens from the same logits, so
no token is broadcast, and a horizon's carry stays on each rank's device
(the ``__carry__`` sentinel). At ``tp`` > 1 the engine refuses
(``ValueError`` naming ROADMAP.md Queue 1 item 6) what a group does not
serve yet: other families, spec decoding, LoRA, vision, guided decoding,
logits processors, KVBM tiers, the transfer plane, drain and checkpoint,
and CUDA graphs over a collective that goes through the host.

Not in this slice (ROADMAP.md): LoRA on families other than dense llama,
gpt-oss and MLA drafts, vision on Qwen3-MoE or with a spec draft, on the
card a llama or Qwen3-MoE model at a head_dim outside {64, 128} or a group
size above 8, and the parallelism beyond TP. A request that asks for one of those is
refused with ``UnsupportedRequestError`` (a 400 at the frontend); an engine configuration that
does, with ``ValueError``. The engine serves behind the port's serving plane as the reference's
does (``python -m dynamo_tpu_torch.engine``: the Backend operator, the TCP request plane and
discovery; ``python -m dynamo_tpu_torch.frontend``: the OpenAI frontend).

Disaggregated prefill/decode (engine/transfer.py): ``serve_transfer``
serves the engine's pages by sequence hash on an endpoint of its own; a
request annotated ``disagg: prefill`` finishes with a ``kv_transfer``
plan (the transfer address and the prompt's full-block hashes), and a
request that carries a ``kv_transfer`` plan pulls those pages before
admission (streamed or blocking, through the wire, the in-process mover
or the device path) and imports them as cached prefix blocks: committed
to the prefix cache and published as stored KV events, as the prefill's
own blocks are. A transfer that fails or falls short leaves the rest to
the local prefill (logged, counted, a flight event). ``kv_commits`` wakes
streamed fetches per committed prefill chunk and per import.
Between hosts the pages move over the native agent (transfer/native.py)
when both sides can. A request that dies with the loop carries an
evacuation plan on its error frame (``_evacuation_plan``: a tier pull of
its full blocks from this worker), which the frontend's Migration replays
on another worker. ``checkpoint.checkpoint_engine`` / ``restore_engine``
save the prefix cache's sealed pages to a G3 checkpoint and import them
into a fresh engine (engine/drain.py drains a worker into one).

Health and observability hooks, all host-side bookkeeping on the loop
thread (never inside a graph capture, never a device sync): ``healthy``
and ``on_crash`` (the crash handler flips and calls them: the worker's
watchdog deregisters the model), ``stats_hook`` (a ``StepStats`` after
every prefill chunk, mixed step, consumed horizon and eager decode step;
engine/telemetry.py), each request's milestones (queued, admitted, prefill
start, first token) on the flight recorder and, at its end, the
``engine.queue`` / ``engine.prefill`` / ``engine.decode`` spans parented on
its ``traceparent`` annotation, the SLO ledger for a request with an
``sla`` annotation, and the attribution aggregates (runtime/). With
``DTPU_ASYNC_PREP`` (default on) the next prefill chunk's arrays are
packed and copied to the device on a prep thread while the current chunk
runs (engine/prep.py).
"""

from __future__ import annotations

import asyncio
import dataclasses
import functools
import hashlib
import json
import logging
import time
import warnings
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, AsyncIterator, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..llm.protocols.common import (
    FINISH_CANCELLED,
    FINISH_ERROR,
    FINISH_LENGTH,
    FINISH_STOP,
    BackendOutput,
    PreprocessedRequest,
)
from ..kvbm.layout import (
    QuantizedBlockCodec,
    block_shape_for,
    from_host,
    storage_dtype,
    to_host,
)
from ..guided import (RegexError, SchemaError, build_token_tables, compile_regex,
                      guided_regex_pattern)
from ..llm.encoder_cache import EncoderCacheManager, content_hash
from ..logits_processing import apply_processors
from ..lora import LoraAdapterTable, PackedAdapterIds, make_lora_fn
from ..models import gemma, llama, moe, registry
from ..models import vision as vis
from ..ops import attention as att
from ..ops import block_copy as bc
from ..ops import cuda_attention, cuda_mla, cuda_prefill, cuda_unified
from ..ops.quant import QuantizedKV, resolve_kv_dtype
from ..parallel import mesh as tp_mesh
from ..runtime.attribution import get_attribution
from ..runtime.engine import Context
from ..runtime.errors import ContextLengthError, GuidedRejectedError, InvalidRequestError
from ..runtime.faults import FAULTS
from ..runtime.flight_recorder import get_flight_recorder
from ..runtime.slo import get_slo_accountant, sla_t0_ns, spec_from_annotations
from ..runtime.tasks import spawn_bg
from ..runtime.tracing import get_tracer
from ..tokens import TokenBlockSequence
from .allocator import BlockAllocator, OutOfBlocks
from .graphs import HorizonGraphs, HorizonState, capture_allowed, seq_len_buckets
from .prep import ChunkPrep, async_prep_enabled
from .telemetry import StepStats
from .sampling import (
    TOP_LOGPROBS_K,
    apply_penalties,
    guided_mask,
    guided_step,
    gumbel_noise,
    gumbel_noise_tensor,
    logprobs_of,
    sample_tokens,
    top_logprobs,
    update_counts,
)

log = logging.getLogger("dynamo_tpu_torch.engine")


class UnsupportedRequestError(InvalidRequestError):
    """The request asks for a feature this engine does not have (a 400 at
    the frontend, code ``invalid_request``, as the reference's
    InvalidRequestError)."""


@dataclasses.dataclass
class TorchEngineConfig:
    model: llama.LlamaConfig
    num_blocks: int = 512
    block_size: int = 16
    max_batch_size: int = 8
    # prompts longer than the largest bucket prefill in chunks of it
    max_context: int = 2048
    prefill_buckets: Tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
    seed: int = 0
    # None = cuda (raises without a GPU); "cpu" runs the plain ops
    device: Optional[str] = None
    # paged-KV storage: "model" (the model dtype), "int8" (int8 pages plus
    # per-block-per-kv-head f32 scales, ops/quant.py), or "auto" (the
    # DTPU_KV_DTYPE env, default "model"), as the reference resolves it
    kv_dtype: str = "auto"
    # decode horizon: decode iterations per dispatch (1: one eager step per
    # tick), and horizons in flight, each chained on the last one's device
    # carry. None = auto-tune both at startup (autotune_decode_schedule),
    # as the reference does.
    decode_steps: Optional[int] = None
    decode_pipeline: Optional[int] = None
    # on CUDA each horizon replays a CUDA graph captured at engine start;
    # False runs the same horizon body eagerly on the card (to compare the
    # two). The CPU always runs it eagerly.
    cuda_graphs: bool = True
    # multimodal: the vision tower (models/vision.py). Prompts carry image
    # placeholder runs (image_token_id); prefill splices the encoded patch
    # features over them (llama.forward's inputs_embeds)
    vision: Optional[vis.VisionConfig] = None
    image_token_id: int = vis.IMAGE_TOKEN_ID
    # speculative decoding: a draft model config enables it (a shadow
    # paged cache addressed by the main cache's block tables; spec_k greedy
    # draft tokens a round, verified by ONE main forward over q_len =
    # spec_k + 1 rows of the unified kernel). Greedy equality is the
    # invariant: the draft only moves the acceptance rate. spec_k is capped
    # at decode_steps
    spec_draft: Optional[llama.LlamaConfig] = None
    spec_k: int = 4
    # multi-LoRA (lora/adapters.py, dense llama family): adapter slots
    # allocated at build, loads written into them in place (the horizon's
    # graphs see a load at their next replay). 0 disables
    lora_max_adapters: int = 0
    lora_rank: int = 16
    lora_targets: Tuple[str, ...] = ("wq", "wk", "wv", "wo")
    # logits processors (logits_processing/): (name, fn) pairs; requests opt
    # in by name (annotation "logits_processors"). () disables
    logits_processors: Tuple[Tuple[str, Any], ...] = ()
    # guided decoding (guided/): the caps of each slot's device tables
    # ([states, classes]); a grammar over them is refused per request. 0
    # disables; enabling needs the constructor's guided_vocab
    guided_max_states: int = 0
    guided_max_classes: int = 320
    # tensor parallelism: the size of the TP group this engine is one rank
    # of (parallel/, runtime/multihost.py); > 1 needs the constructor's
    # joined ``multihost`` group
    tp: int = 1

    def __post_init__(self):
        bad = [b for b in self.prefill_buckets if b % self.block_size]
        if bad:
            raise ValueError(
                f"prefill_buckets {bad} not multiples of block_size {self.block_size}"
            )
        for name in ("decode_steps", "decode_pipeline"):
            if getattr(self, name) is not None and getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1 (or None to auto-tune)")
        self.kv_dtype = resolve_kv_dtype(self.kv_dtype)

    @property
    def kv_quantized(self) -> bool:
        return self.kv_dtype == "int8"

    @property
    def prefill_chunk(self) -> int:
        """Largest single prefill dispatch; longer prompts chunk at this."""
        return self.prefill_buckets[-1]

    @property
    def max_blocks_per_seq(self) -> int:
        return (self.max_context + self.block_size - 1) // self.block_size


@dataclasses.dataclass
class _Seq:
    req: PreprocessedRequest
    context: Context
    out_queue: asyncio.Queue
    seq: TokenBlockSequence               # prompt + generated
    slot: int = -1
    block_ids: List[int] = dataclasses.field(default_factory=list)
    produced: int = 0
    last_token: int = 0
    cached_tokens: int = 0
    prefill_pos: int = 0                  # prompt tokens whose KV is written
    kv_written: int = 0                   # leading tokens whose KV a decode wrote
    commit_upto: int = 0                  # prompt blocks content-addressed so far
    prefilled: bool = False               # first token sampled -> decode eligible
    counting: bool = False                # keeps output_counts (penalties)
    # multimodal: per-prompt-position soft tokens over the image spans,
    # mm_embeds [prompt_len, H] float32 and mm_mask [prompt_len] bool.
    # Placeholder ids hash alike for different images, so such prompts
    # never match or enter the prefix cache (no_cache)
    mm_embeds: Optional[np.ndarray] = None
    mm_mask: Optional[np.ndarray] = None
    no_cache: bool = False
    # speculative decoding: prompt positions whose DRAFT KV is written, and
    # whether this request can ride spec rounds (greedy, no penalties, no
    # logprobs); others skip the draft prefill (their draft KV is never read)
    draft_prefill_pos: int = 0
    spec_ok: bool = False
    # guided decoding: the compiled token tables and the FSM state after
    # the tokens applied so far (host view; a chained horizon carries its
    # own on the device)
    guided_tables: Optional[Any] = None
    guided_state: int = 0
    done: bool = False
    # lifecycle milestones (unix ns, 0 = not reached), stamped on the loop
    # thread; the request's spans and flight events come from them
    t_queued: int = 0
    t_admitted: int = 0
    t_prefill_start: int = 0
    t_first_token: int = 0
    # the request's SLA promise (runtime/slo.py); None = unclassified
    sla: Optional[Any] = None


# (sequence, token, logprob, top-logprob ids or None, top-logprob values or None)
Accepted = Tuple[_Seq, int, float, Optional[List[int]], Optional[List[float]]]


def _has_penalties(s) -> bool:
    return (
        s.presence_penalty != 0.0
        or s.frequency_penalty != 0.0
        or s.repetition_penalty != 1.0
    )


def _kernel_shape_error(cfg, role: str) -> Optional[str]:
    """Why the card's decode and flash-extend kernels have no form for a
    llama-family or Qwen3-MoE model's attention, or None."""
    if (cuda_attention.supports(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
            and cuda_prefill.supports(cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)):
        return None
    g = cfg.num_heads // cfg.num_kv_heads if cfg.num_heads % cfg.num_kv_heads == 0 else None
    return (f"the {role} model's {cfg.num_heads} heads over {cfg.num_kv_heads} kv heads at "
            f"head_dim {cfg.head_dim} (group size {g}): the decode kernel takes head_dim in "
            f"{cuda_attention.HEAD_DIMS} and group sizes {cuda_attention.GROUP_SIZES[0]}-"
            f"{cuda_attention.GROUP_SIZES[-1]}, flash-extend head_dim in "
            f"{cuda_prefill.HEAD_DIMS} and group sizes up to {cuda_prefill.TILE_ROWS}; "
            "other shapes on the card are queued in ROADMAP.md (Queue 1); device='cpu' "
            "serves them")


def _check_features(config: TorchEngineConfig, guided_vocab=None) -> None:
    """Refuse, before anything is allocated, the configurations this port
    does not serve yet (ROADMAP.md Queue 1): on the card a llama-family or
    Qwen3-MoE main or draft model whose shape the decode or flash-extend
    kernel lacks (the CPU's plain ops serve every shape), and a draft of
    the gpt-oss or MLA family; and, as the reference, vision on a Qwen3-MoE
    main, vision with a spec draft, a draft of another vocabulary, LoRA
    outside the dense llama family or with spec decoding, and guided
    decoding without the vocabulary's byte forms."""
    m, d = config.model, config.spec_draft
    on_card = torch.device(config.device or "cuda").type == "cuda"
    if config.lora_max_adapters > 0:
        if registry.family(m) is not llama:
            raise ValueError("LoRA serving covers the llama/qwen dense family only")
        if d is not None:
            raise ValueError("speculative decoding covers the text path (no vision/"
                             "LoRA yet)")
    if config.guided_max_states > 0 and guided_vocab is None:
        raise ValueError("guided decoding needs guided_vocab=(vocab byte forms, eos_id) "
                         "— see guided.vocab_bytes_from_tokenizer")
    if config.vision is not None:
        if registry.family(m) is moe:
            raise ValueError("multimodal serving covers the dense families only: a "
                             "Qwen3-MoE main is refused, as in the reference (ROADMAP.md "
                             "Queue 1)")
        if config.vision.out_hidden_size != m.hidden_size:
            raise ValueError("vision.out_hidden_size must match the language model "
                             f"hidden size ({m.hidden_size})")
    if d is not None:
        if config.vision is not None:
            raise ValueError("speculative decoding covers the text path: vision with a "
                             "spec_draft is refused, as in the reference (ROADMAP.md "
                             "Queue 1)")
        if registry.family(d) not in (llama, moe, gemma):
            raise ValueError(f"a {registry.family(d).__name__.rsplit('.', 1)[-1]} draft "
                             "model is not served in this port: drafts of the dense llama, "
                             "Qwen3-MoE and Gemma families are (ROADMAP.md Queue 1)")
        if d.vocab_size != m.vocab_size:
            raise ValueError(f"draft and main model must share a vocabulary ({d.vocab_size} "
                             f"!= {m.vocab_size}; ROADMAP.md Queue 1)")
    if on_card:
        # at tp > 1 each rank's kernels run at its own heads
        for role, cfg in (("main", tp_mesh.local_config(m, config.tp)), ("draft", d)):
            if cfg is not None and registry.family(cfg) in (llama, moe):
                err = _kernel_shape_error(cfg, role)
                if err is not None:
                    raise ValueError(err)


def _check_tp(config: TorchEngineConfig, guided_vocab, kvbm, multihost) -> None:
    """Refuse, at ``tp`` > 1, each combination a TP group does not serve
    yet (``ValueError`` naming ROADMAP.md Queue 1 item 6), and a group that
    is not joined. The transfer plane, drain and checkpoint refuse at
    their own entries (``serve_transfer``, ``import_blocks``,
    engine/checkpoint.py)."""
    if config.tp == 1:
        if multihost is not None:
            raise ValueError("a multihost group serves tp > 1 only")
        return

    def refuse(what: str) -> None:
        raise ValueError(f"tensor parallelism (tp={config.tp}) does not serve {what} yet "
                         f"({tp_mesh.QUEUE})")

    m = config.model
    if registry.family(m) is not llama:
        refuse(f"the {registry.family(m).__name__.rsplit('.', 1)[-1]} family (the dense "
               "llama family is served)")
    tp_mesh.check_tp(m, config.tp)
    if config.spec_draft is not None:
        refuse("speculative decoding")
    if config.lora_max_adapters > 0:
        refuse("LoRA")
    if config.vision is not None:
        refuse("vision")
    if config.guided_max_states > 0 or guided_vocab is not None:
        refuse("guided decoding")
    if config.logits_processors:
        refuse("logits processors")
    if kvbm is not None:
        refuse("KVBM tiers")
    if (multihost is None or multihost.comm is None
            or multihost.num_processes != config.tp):
        raise ValueError(f"tp={config.tp} needs this rank's joined multihost group of "
                         f"{config.tp} processes (runtime/multihost.py)")
    on_card = torch.device(config.device or "cuda").type == "cuda"
    if on_card and config.cuda_graphs and multihost.comm.host_staged:
        raise ValueError(f"cuda_graphs=True over {multihost.comm.backend} on CUDA tensors "
                         "(ranks that share a card): a collective that goes through the "
                         "host cannot be captured in a CUDA graph; pass cuda_graphs=False "
                         f"for eager horizons (a capturable collective: {tp_mesh.QUEUE})")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_device_rtt(device, tries: int = 3) -> float:
    """Median launch -> readback round trip of a trivial op: the op, then a
    real copy of its result to the host (``.cpu()``), as the reference
    probes with ``np.asarray``."""
    x = torch.zeros(8, dtype=torch.float32, device=device)
    (x + 1).cpu()   # warm the op
    samples = []
    for _ in range(tries):
        t0 = time.perf_counter()
        (x + 1).cpu()
        samples.append(time.perf_counter() - t0)
    samples.sort()
    return samples[len(samples) // 2]


def measure_copy_rate(device, tries: int = 3) -> float:
    """Bytes per second the device reads and writes in a device-to-device
    copy, best of ``tries`` after a warm-up: the rate a decode step reads
    the weights at (256 MiB copied on CUDA, 32 MiB elsewhere)."""
    device = torch.device(device)
    nbytes = 1 << 28 if device.type == "cuda" else 1 << 25
    src = torch.ones(nbytes, dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    _sync(device)
    best = float("inf")
    for _ in range(tries):
        t0 = time.perf_counter()
        dst.copy_(src)
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return 2 * nbytes / best


def param_bytes(params) -> int:
    """Bytes of every tensor in a parameter tree (dicts and lists)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    items = params.values() if isinstance(params, dict) else params
    return sum(param_bytes(p) for p in items)


def autotune_decode_schedule(params, device) -> Tuple[Tuple[int, int], dict]:
    """((decode_steps, decode_pipeline), the measurements): the reference's
    rule with this device's own numbers. A decode step reads every weight
    once, so t_step = weight bytes / the device's measured copy rate; the
    horizon is the power of two in [8, 64] nearest above RTT / t_step
    steps, so that its compute covers a readback's round trip; and a
    second horizon is kept in flight when the round trip is longer than
    two steps. (The reference's 816 GB/s and 0.45 are TPU calibrations and
    no prior here.)"""
    rate = measure_copy_rate(device)
    t_step = max(param_bytes(params) / rate, 1e-6)
    rtt = measure_device_rtt(device)
    steps = 8
    while steps < 64 and steps < rtt / t_step:
        steps *= 2
    pipeline = 2 if rtt > 2 * t_step else 1
    log.info("decode schedule auto-tuned: rtt=%.3fms copy rate=%.0f GB/s t_step~%.3fms "
             "-> steps=%d pipeline=%d", rtt * 1e3, rate / 1e9, t_step * 1e3, steps, pipeline)
    return (steps, pipeline), {"rtt_s": rtt, "copy_bytes_s": rate, "t_step_s": t_step}


@dataclasses.dataclass
class _Chain:
    """A decode horizon in flight: the host slot its packed [N, B, 2+2K]
    results are copied to and the event after that copy, the sequence
    snapshot taken at dispatch (results are never applied to a sequence
    admitted into a recycled slot later), the device carry's seq_lens
    after it (host mirror: what the next chained horizon starts from), and
    the fetch thread's future."""
    seqs: List[Optional["_Seq"]]
    host: torch.Tensor
    event: Any
    lens_after: np.ndarray
    fetch: Any = None
    spec: bool = False    # a spec horizon: packed [R, B, 1+2k]; lens_after a bound


class _UnifiedRows:
    """One step's arguments of the unified kernel, each moved to the
    device on first use: the row arrays (q_starts, q_lens, seq_lens), and
    one [R] windows array per distinct window a layer asks for; and
    ``max_seq_len``, the host's bound on seq_lens that sizes the kernel's
    split-K grid."""

    def __init__(self, to_device, q_starts, q_lens, seq_lens):
        self._t = to_device
        self._host = (q_starts, q_lens, seq_lens)
        self._rows = None
        self._windows = {}
        self.max_seq_len = int(np.max(seq_lens, initial=0))

    def rows(self) -> List[torch.Tensor]:
        if self._rows is None:
            self._rows = [self._t(a, torch.int32) for a in self._host]
        return self._rows

    def attrs(self, window: Optional[int] = None, **extra) -> dict:
        """A layer's attention attributes as the kernel takes them: its
        sliding window (None: full) as an [R] windows array."""
        if window:
            if window not in self._windows:
                R = len(self._host[0])
                self._windows[window] = self._t(np.full(R, window), torch.int32)
            extra["windows"] = self._windows[window]
        return extra


class TorchEngine:
    """AsyncEngine serving PreprocessedRequests with a llama-, gemma-,
    gpt-oss-, Qwen3-MoE- or MLA-family model.

    ``multihost`` (runtime/multihost.MultihostContext, its group joined and
    its control channel up) makes the engine one rank of a ``tp`` > 1
    group: ``params`` are then the rank's shards (engine/weights.
    shard_params; None draws the rank's shard of the seed's random
    weights), the leader serves requests, and a follower calls
    ``follow()``."""

    def __init__(self, config: TorchEngineConfig, params: Optional[llama.Params] = None,
                 kvbm=None, draft_params: Optional[llama.Params] = None,
                 vision_params: Optional[dict] = None,
                 guided_vocab: Optional[Tuple[List[Optional[bytes]], int]] = None,
                 kv_publisher=None, metrics_publisher=None, multihost=None):
        _check_tp(config, guided_vocab, kvbm, multihost)
        _check_features(config, guided_vocab)
        self.cfg = config
        # tensor parallelism: this rank's group, collectives and index
        self.tp = config.tp
        self._mh = multihost
        self.comm = multihost.comm if multihost is not None else None
        self.rank = multihost.spec.process_id if multihost is not None else 0
        self.is_leader = self.rank == 0
        # the KV router's feeds (kv_router/publisher.py): the allocator's
        # stored / removed events and the load, published at the end of
        # every loop tick (_publish_events); None publishes nothing (the
        # events are drained all the same)
        self.kv_publisher = kv_publisher
        self.metrics_publisher = metrics_publisher
        self._last_published_load: Optional[tuple] = None
        # the config this rank computes with: its heads at tp > 1
        self.mcfg = mcfg = tp_mesh.local_config(config.model, config.tp)
        # an MLA model's attention runs on its latent cache (ops/cuda_mla)
        self._latent = registry.is_mla(mcfg)
        if self._latent and config.kv_quantized:
            raise ValueError("an MLA model's latent cache has no int8 form yet: "
                             "use kv_dtype='model'")
        self.device = resolve_device(config.device)
        self.kv_quantized = config.kv_quantized
        self.allocator = BlockAllocator(config.num_blocks, config.block_size)
        self._host_rng = np.random.default_rng(config.seed)
        dev = self.device
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(config.seed)
            if self.tp > 1:
                from .weights import init_sharded_params

                params = init_sharded_params(config.model, gen, dev, self.rank, self.tp)
            else:
                params = registry.init_params(mcfg, gen, dev)
        self.params = params
        self._forward = registry.forward_fn(mcfg)
        self._lm_logits = registry.lm_logits_fn(mcfg)
        if self.tp > 1:
            self._forward = functools.partial(llama.forward, tp=self.comm)
            self._lm_logits = functools.partial(llama.lm_logits, tp=self.comm)
        self.k_caches = self._init_caches()
        self.v_caches = self._init_caches()
        # the decode schedule (both knobs size the horizon's buffers and
        # graphs); the measurements behind an auto-tuned one. A TP group
        # takes its leader's
        self.schedule: Dict[str, Any] = {}
        if config.decode_steps is None or config.decode_pipeline is None:
            (steps, pipeline), self.schedule = autotune_decode_schedule(params, dev)
            if self.tp > 1:
                mine = [steps, pipeline] if self.is_leader else [0, 0]
                steps, pipeline = (int(v) for v in self.comm.all_reduce(
                    torch.tensor(mine, dtype=torch.float32, device=dev)).tolist())
            if config.decode_steps is None:
                config.decode_steps = steps
            if config.decode_pipeline is None:
                config.decode_pipeline = pipeline

        # --- vision tower + encoder cache (reference seed: seed + 1) ---
        self.vision_params = self.encoder_cache = None
        self._mm_zero: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}
        if config.vision is not None:
            if vision_params is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(config.seed + 1)
                vision_params = vis.init_params(config.vision, gen, dev)
            self.vision_params = vision_params
            self.encoder_cache = EncoderCacheManager()
        # the fused mixed step does not carry the splice (as in the reference)
        self.mixed_enabled = config.vision is None

        # --- speculative decoding: draft model + shadow paged cache ---
        # The draft cache mirrors the main cache's block geometry and is
        # addressed by the SAME block tables (same block id => same tokens
        # => same draft KV), so it needs no second allocator; it stays in
        # the draft's dtype under an int8 main cache: its values only move
        # the acceptance rate, never the tokens. A spec horizon advances at
        # most rounds * spec_k <= decode_steps tokens, which the horizon's
        # page booking covers.
        self._spec = config.spec_draft is not None
        self.draft_params = self.draft_k_caches = self.draft_v_caches = None
        self._spec_rounds = 0
        if self._spec:
            dcfg = config.spec_draft
            config.spec_k = max(1, min(config.spec_k, config.decode_steps))
            self._spec_rounds = max(1, config.decode_steps // config.spec_k)
            if draft_params is None:
                gen = torch.Generator(device=dev)
                gen.manual_seed(config.seed + 2)
                draft_params = registry.init_params(dcfg, gen, dev)
            self.draft_params = draft_params
            self._draft_forward = registry.forward_fn(dcfg)
            self._draft_logits = registry.lm_logits_fn(dcfg)
            self.draft_k_caches = self._init_caches(dcfg, quantized=False)
            self.draft_v_caches = self._init_caches(dcfg, quantized=False)
        # acceptance: rounds = per-row rounds applied, emitted = tokens the
        # device advanced (before stop truncation); rate = emitted /
        # (rounds * k), 1.0 for a perfect draft
        self.spec_stats = {"rounds": 0, "emitted": 0, "k": config.spec_k}

        # --- slot state (the decode batch is fixed-width) ---
        B, V = config.max_batch_size, mcfg.vocab_size
        self._slots: List[Optional[_Seq]] = [None] * B
        self._tokens = np.zeros(B, np.int64)
        self._block_tables = np.zeros((B, config.max_blocks_per_seq), np.int32)
        self._temps = np.zeros(B, np.float32)
        self._top_ks = np.zeros(B, np.int64)
        self._top_ps = np.ones(B, np.float32)
        self._min_ps = np.zeros(B, np.float32)
        self._pres = np.zeros(B, np.float32)
        self._freqs = np.zeros(B, np.float32)
        self._reps = np.ones(B, np.float32)
        self._lp_ns = np.zeros(B, np.int32)    # requested top-logprobs per slot
        self._seeds = np.zeros(B, np.uint32)   # the reference's uint32 seeds
        # penalty state tables (see engine/sampling.py)
        self.output_counts = torch.zeros((B, V), dtype=torch.int32, device=dev)
        self.prompt_masks = torch.zeros((B, V), dtype=torch.int8, device=dev)
        self._slot_dirty = np.zeros(B, bool)   # slot's penalty rows need reset

        # --- per-request features (all off: no table, no graph, no op) ---
        # LoRA: the adapter tables (slot 0 the identity) and each batch
        # slot's adapter slot
        self.lora = None
        if config.lora_max_adapters > 0:
            self.lora = LoraAdapterTable(mcfg, config.lora_max_adapters, config.lora_rank,
                                         config.lora_targets, dtype=mcfg.dtype, device=dev)
        self._lora_slots = np.zeros(B, np.int64)
        # logits processors: each slot's opt-ins, one column per processor
        self._procs = tuple(config.logits_processors)
        self._lp_masks = np.zeros((B, max(1, len(self._procs))), bool)
        # guided decoding: each slot's token tables on the device ([B, V]
        # class map, int64 as the gathers index with it; [B, S_cap, C_cap]
        # transitions; written in place at a guided admission), the
        # guided rows and their FSM states (host)
        self.guided_enabled = config.guided_max_states > 0
        self._g_active = np.zeros(B, bool)
        self._g_state = np.zeros(B, np.int32)
        self.g_class = self.g_trans = None
        if self.guided_enabled:
            self._g_vocab, self._g_eos = guided_vocab
            self.g_class = torch.zeros((B, V), dtype=torch.int64, device=dev)
            self.g_trans = torch.full((B, config.guided_max_states, config.guided_max_classes),
                                      -1, dtype=torch.int32, device=dev)
            # grammar key -> future of its TokenTables; compiles run on a
            # thread of their own, so a cold grammar holds no step back
            self._g_cache: Dict[str, Any] = {}
            self._guided_executor = ThreadPoolExecutor(max_workers=1,
                                                       thread_name_prefix="torch-guided")

        self._waiting: List[_Seq] = []
        # embedding requests for the loop: (token ids, future of the vector)
        self._embed_waiting: List[Tuple[List[int], asyncio.Future]] = []
        self._prefill_rr = 0  # round-robin cursor over prefilling sequences
        self._loop_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._idle = True   # the loop is parked with no request to serve
        # dispatches run so far, by kind ("prefill" | "decode" | "mixed" |
        # "horizon": one multi-step decode dispatch | "spec": one spec horizon)
        self.step_counts: Dict[str, int] = {"prefill": 0, "decode": 0, "mixed": 0,
                                            "horizon": 0, "spec": 0, "embed": 0}
        # the tokens this rank's ops sampled, by kind, in dispatch order:
        # equal on every rank of a TP group (sampled_digest)
        self._sampled = {kind: [hashlib.sha256(), 0] for kind in ("eager", "horizon")}
        self._last_fetch = None
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="torch-step")
        # health: the crash handler flips ``healthy`` and calls
        # ``on_crash(exc)`` (the worker's watchdog deregisters the model)
        self.healthy = True
        self.on_crash: Optional[Any] = None
        # step telemetry (engine/telemetry.py): callable(StepStats) after
        # every prefill chunk, mixed step, consumed horizon and eager
        # decode step; None = off
        self.stats_hook: Optional[Any] = None
        # async host chunk prep (engine/prep.py): the next prefill chunk's
        # arrays packed and copied to the device on a prep thread while
        # the current chunk runs; the copies go on the stream the step
        # executor launches on (this thread's current stream, the default)
        self._stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
        # (not at tp > 1: a chunk's arrays go to every rank with its op)
        self._prep = (ChunkPrep(self._chunk_arrays, upload=self._prep_upload)
                      if async_prep_enabled() and self.tp == 1 else None)
        # horizons in flight, oldest first; their readbacks wait on the
        # fetch thread so the step thread keeps dispatching
        self._chains: Deque[_Chain] = deque()
        self._fetch_executor = ThreadPoolExecutor(max_workers=1,
                                                  thread_name_prefix="torch-fetch")

        # --- KVBM (kvbm/pool.py): sealed blocks write through to host/disk ---
        self.kvbm = kvbm
        # fleet-wide KV reuse (kvbm/directory.py): the serving glue attaches
        # a GlobalKvDirectory when DTPU_GLOBAL_KV is on; _publish_events
        # keeps its advertisements up to date
        self.kv_directory = None
        # the weight owner's connection when the weights were imported from
        # one (engine/weight_service.py): the import's lease
        self.weight_lease = None
        # (block id, sequence hash, priority) whose KV is written and that
        # wait for the next offload batch: 0 = prompt blocks (highest reuse
        # odds), 1 = decode-sealed blocks
        self._offload_pending: List[Tuple[int, int, int]] = []
        # decode-sealed blocks whose last row is not written yet: (sequence,
        # block index, block id, sequence hash). A block enters the prefix
        # cache (and the offload queue) only once a step has written it
        # (_commit_written_blocks)
        self._sealed_unwritten: List[Tuple[_Seq, int, int, int]] = []
        # errors of the offload thread (device-to-host copy, encoding); the
        # gather kernels run on the step executor and raise into the loop
        self.offload_errors = 0
        self._offload_executor = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-offload"
        )
        self._offload_stream = (
            torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        )
        self._codec = (
            QuantizedBlockCodec(block_shape_for(mcfg, config.block_size, "int8"))
            if self.kv_quantized else None
        )
        # disaggregation (engine/transfer.py): this engine's transfer
        # server and its address, the client of its pulls, and the commit
        # signal streamed fetches wait on (made with the server)
        self.transfer_address: Optional[str] = None
        self._transfer_server = None
        self._kv_transfer_srv = None
        self._transfer_client = None
        self.kv_commits = None
        self._horizon: Optional[HorizonGraphs] = None
        if config.decode_steps > 1:
            self._horizon = self._build_horizon()
        self._op = self._device_ops()

    def _device_ops(self) -> Dict[str, Any]:
        """name -> the device op each step kind ends in: the method itself
        on one rank; at tp > 1 the leader's call broadcasts its arguments
        first (runtime/multihost.MultihostOps.leader_fn) and a follower
        replays them (``follow``). A horizon's carry passes as the device
        tensor when it chains on the last horizon's (the ``__carry__``
        sentinel on the wire)."""
        ops = {"admit": self._dev_admit, "prefill": self._dev_prefill,
               "decode": self._dev_decode, "mixed": self._dev_mixed,
               "horizon": self._dev_horizon, "embed": self._run_embed,
               "probe_collectives": self._dev_probe_collectives}
        if self._mh is None:
            return ops
        self._mh_ops = self._mh.router.table({}, {})
        for name, fn in ops.items():
            carry = name == "horizon"
            self._mh_ops.register(name, fn, state_out={2: "carry_hz"} if carry else None,
                                  carry_in={1: "carry_hz"} if carry else None)
        if not self.is_leader:
            return ops
        return {name: self._mh_ops.leader_fn(name) for name in ops}

    def follow(self) -> None:
        """A follower's body: replay the leader's device ops until it stops
        the group (``stop``) or its channel closes."""
        if self._mh is None or self.is_leader:
            raise RuntimeError("follow() runs on a follower rank of a TP group")
        self._mh_ops.follow()

    def _build_horizon(self) -> HorizonGraphs:
        """The horizon's static buffers, and on CUDA (unless ``cuda_graphs``
        is off) its graphs, captured now, before any traffic."""
        c, m = self.cfg, self.mcfg
        # the windows of the main's layers and of a (Gemma) draft's
        windows = set()
        for cfg in (m, c.spec_draft):
            window_for = getattr(cfg, "window_for_layer", None)
            if window_for is not None:
                windows |= {w for w in map(window_for, range(cfg.num_layers)) if w}
        windows = sorted(windows)
        state = HorizonState(c.max_batch_size, c.max_blocks_per_seq, c.decode_steps,
                             m.vocab_size, TOP_LOGPROBS_K, self.device, windows,
                             slots=c.decode_pipeline,
                             spec=(self._spec_rounds, c.spec_k) if self._spec else None,
                             guided=self.guided_enabled, lora=self.lora is not None,
                             processors=len(self._procs))
        capture = capture_allowed(self.device, c.cuda_graphs, self.comm)
        # the split scratch of the kernels the decode steps reach, whatever
        # the main's family: the decode kernel's for a llama or Qwen3-MoE
        # main and for such a draft's steps (gemma's and gpt-oss's layers
        # all go through the unified kernel); the latent kernel's for MLA,
        # per row, so the reserve for the mixed step's B + 1 rows in either
        # form also covers the B verify rows of k + 1 tokens. (The unified
        # kernel's scratch, the verify rows' too, comes from the graphs'
        # pool.) Both kernels share one buffer, which each reserve only grows.
        decode_cfgs = [cfg for cfg in (m, c.spec_draft)
                       if cfg is not None and registry.family(cfg) in (llama, moe)]

        def reserve():
            if self._latent:
                cuda_mla.reserve(self.device, c.max_batch_size + 1, m.num_heads,
                                 c.max_context)
            for cfg in decode_cfgs:
                cuda_attention.reserve(self.device, c.max_batch_size, cfg.num_heads,
                                       cfg.num_kv_heads, c.max_context, cfg.head_dim)
        graphs = HorizonGraphs(
            self._decode_multi, state,
            seq_len_buckets(c.max_context, cuda_attention.DEC_SPLIT_KEYS), self.device,
            capture, reserve=reserve, spec_body=self._spec_multi if self._spec else None)
        if capture:
            graphs.capture_all()
            log.info("decode horizon: %d CUDA graphs of %d steps (%d spec) captured in "
                     "%.2f s, pool %.1f MiB", graphs.stats()["graphs"], c.decode_steps,
                     len(graphs.spec_graphs), graphs.capture_s, graphs.pool_bytes / 2**20)
        return graphs

    def horizon_stats(self) -> dict:
        """Graphs, capture seconds, pool bytes and replays of the horizon."""
        return self._horizon.stats() if self._horizon is not None else {}

    # ------------------------------------------------------ kv transfer wiring
    async def serve_transfer(self, host: str = "127.0.0.1") -> str:
        """Start the KV fetch endpoint (the prefill side of disaggregation;
        a decode worker serves it too, for its peers); returns its
        address, also registered in ``transfer.LOCAL_SERVERS`` for clients
        in this process."""
        from ..runtime.request_plane.tcp import TcpRequestServer
        from ..transfer import ensure_native
        from .transfer import LOCAL_SERVERS, KvCommitSignal, KvTransferServer

        self._refuse_at_tp("the KV transfer plane")
        if self.kv_commits is None:
            self.kv_commits = KvCommitSignal()
        # the native agent's library, built now (a few seconds, once per
        # source) so that no fetch waits for a compiler; a failure is
        # logged and the plane answers inline
        await asyncio.get_running_loop().run_in_executor(None, ensure_native)
        srv = KvTransferServer(self, host=host)
        self._kv_transfer_srv = srv
        self._transfer_server = TcpRequestServer(srv.handle, host=host)
        self.transfer_address = await self._transfer_server.start()
        LOCAL_SERVERS[self.transfer_address] = srv
        return self.transfer_address

    def _get_transfer_client(self):
        if self._transfer_client is None:
            from .transfer import KvTransferClient

            self._transfer_client = KvTransferClient(self)
        return self._transfer_client

    def _refuse_at_tp(self, what: str) -> None:
        """A path a TP group does not serve yet (ROADMAP.md Queue 1 item 6)."""
        if self.tp > 1:
            raise ValueError(f"tensor parallelism (tp={self.tp}) does not serve {what} yet "
                             f"({tp_mesh.QUEUE})")

    @property
    def kv_bytes_per_block(self) -> int:
        """Wire and storage bytes of one KV block (the transfer-cost signal
        ``register_llm`` advertises for transfer-aware routing)."""
        from ..kvbm.layout import kv_bytes_per_token

        kv_dtype = "int8" if self.kv_quantized else "model"
        return int(kv_bytes_per_token(self.mcfg, self.cfg.block_size, kv_dtype)
                   * self.cfg.block_size)

    def _evacuation_plan(self, st: _Seq) -> Optional[Dict[str, Any]]:
        """The evacuation reference an error-finish frame carries: the
        frontend's Migration replays it as the retry's ``kv_transfer`` (a
        tier pull: the holder's KVBM host tier outlives its engine loop),
        and routing prices destinations by the pull. None when the request
        has nothing fetchable (no transfer server, ``no_cache``, or no full
        block computed yet)."""
        if self.transfer_address is None or st.no_cache:
            return None
        hashes = [int(h) for h in st.seq.sequence_hashes()]
        n_tokens = len(st.req.token_ids) + int(st.produced)
        blocks = min(len(hashes), n_tokens // self.cfg.block_size)
        if blocks <= 0:
            return None
        return {"address": self.transfer_address, "hashes": hashes[:blocks],
                "num_tokens": blocks * self.cfg.block_size, "tier": True,
                "bytes_per_block": int(self.kv_bytes_per_block)}

    def transfer_snapshot(self) -> Dict[str, Any]:
        """The transfer plane's host counters (``/debug/worker``)."""
        from .transfer import transfer_stats

        out: Dict[str, Any] = {"address": self.transfer_address,
                               "fallbacks": transfer_stats.snapshot()}
        if self._kv_transfer_srv is not None:
            out["server"] = self._kv_transfer_srv.snapshot()
        if self._transfer_client is not None:
            out["client"] = self._transfer_client.snapshot()
        return out

    async def _import_transferred(self, req: PreprocessedRequest) -> None:
        """Pull a ``kv_transfer`` plan's pages before admission, with the
        fetch's flight events (fetch_started, then fetch_committed or
        fetch_aborted, and transfer). A failure leaves the prefix to the
        local prefill (counted by the client as a recompute).

        A ``tier`` plan (the global KV directory's) pulls from the holder's
        KVBM G2/G3 instead of its device cache, under a directory fetch
        lease that every path out discharges: a commit on any import, an
        abort (the recompute) on zero progress or a failure. A plan whose
        holder is this worker is dropped: its own tiers hold the blocks,
        and the KVBM onboard imports them with no loopback copy."""
        plan = req.kv_transfer
        directory = self.kv_directory
        is_tier = bool(plan.get("tier"))
        if is_tier and directory is not None and plan.get("holder") == directory.holder:
            return
        flight = get_flight_recorder()
        hashes = [int(h) for h in plan.get("hashes", [])]
        lease = (directory.begin_fetch(plan.get("holder", ""), hashes)
                 if is_tier and directory is not None else None)
        flight.record(req.request_id, "fetch_started", holder=plan.get("holder", ""),
                      tier=is_tier, blocks=len(hashes))
        try:
            got = await self._get_transfer_client().fetch_and_import(
                plan["address"], hashes, traceparent=(req.annotations or {}).get("traceparent"),
                stream=bool(plan.get("stream")), request_id=req.request_id, tier=is_tier)
            if lease is not None:
                if got > 0:
                    directory.commit_fetch(lease, got)
                else:
                    directory.abort_fetch(lease)
            if got > 0:
                flight.record(req.request_id, "fetch_committed", tokens=got)
            else:
                flight.record(req.request_id, "fetch_aborted", reason="zero_progress")
            log.debug("imported %d transferred kv tokens for %s", got, req.request_id[:8])
            flight.record(req.request_id, "transfer", tokens=got, address=plan["address"])
        except Exception as e:
            if lease is not None:
                directory.abort_fetch(lease)
            log.exception("kv transfer failed; recomputing the prefill locally")
            flight.record(req.request_id, "fetch_aborted", reason=str(e)[:200])
            flight.record(req.request_id, "transfer", tokens=0, error=str(e)[:200],
                          address=plan["address"])

    def _init_caches(self, m=None, quantized: Optional[bool] = None) -> list:
        """One zeroed paged cache per layer of ``m`` (default: the model):
        raw model-dtype tensors, or ``QuantizedKV`` (int8 payload + f32
        [num_blocks, kv_heads] scales) on an int8 engine unless
        ``quantized`` says otherwise."""
        c, m = self.cfg, m or self.mcfg
        shape = (c.num_blocks, c.block_size, m.num_kv_heads, m.head_dim)
        if self.kv_quantized if quantized is None else quantized:
            return [QuantizedKV(torch.zeros(shape, dtype=torch.int8, device=self.device),
                                torch.zeros((c.num_blocks, m.num_kv_heads),
                                            dtype=torch.float32, device=self.device))
                    for _ in range(m.num_layers)]
        return [torch.zeros(shape, dtype=m.dtype, device=self.device)
                for _ in range(m.num_layers)]

    # ------------------------------------------------------------ requests
    def _check_request(self, req: PreprocessedRequest) -> List[int]:
        """Refuse what this engine cannot serve as asked; returns the prompt
        (token_ids + prior_token_ids, as the reference). The feature
        refusals are the reference's: an unknown processor, LoRA on an
        engine without it or an unknown adapter, and a grammar on an engine
        without guided decoding (a ``soft`` one is served unconstrained)."""
        ann = req.annotations or {}
        wanted = ann.get("logits_processors") or []
        if wanted:
            known = {n for n, _ in self._procs}
            bad = [n for n in wanted if n not in known]
            if bad:
                raise UnsupportedRequestError(f"unknown logits processors {bad!r}")
        name = ann.get("lora")
        if name:
            if self.lora is None:
                raise UnsupportedRequestError("engine built without LoRA support")
            if self.lora.slot_of(name) == 0:
                raise UnsupportedRequestError(f"unknown LoRA adapter {name!r}")
        if ann.get("images") and self.cfg.vision is None:
            raise UnsupportedRequestError("this engine was built without a vision tower")
        if ann.get("op") == "embed" and ann.get("images"):
            raise UnsupportedRequestError("embeddings take text prompts only")
        guided = req.sampling.guided
        if guided is not None and not self.guided_enabled and not guided.get("soft"):
            raise UnsupportedRequestError("engine built without guided decoding "
                                          "(guided_max_states=0)")
        if self.tp > 1 and req.kv_transfer:
            raise UnsupportedRequestError(f"a kv_transfer plan: tensor parallelism does not "
                                          f"serve the transfer plane yet ({tp_mesh.QUEUE})")
        seed = req.sampling.seed
        if seed is not None and not 0 <= seed < 1 << 32:
            raise ValueError(f"seed {seed} outside [0, 2**32): seeds key as uint32")
        prompt = list(req.token_ids) + list(req.prior_token_ids)
        if not prompt:
            raise ValueError("empty prompt")
        V = self.mcfg.vocab_size
        image_id = self.cfg.image_token_id if self.cfg.vision is not None else None
        if any(not 0 <= t < V and t != image_id for t in prompt):
            raise ValueError(f"prompt token ids outside the vocab of {V}")
        if len(prompt) >= self.cfg.max_context:
            raise ValueError(
                f"prompt {len(prompt)} tokens exceeds engine max_context "
                f"{self.cfg.max_context}"
            )
        if len(prompt) // self.cfg.block_size + 2 > self.cfg.num_blocks:
            raise ContextLengthError(
                f"prompt {len(prompt)} tokens cannot fit the KV pool "
                f"({self.cfg.num_blocks} blocks x {self.cfg.block_size})"
            )
        return prompt

    async def generate(self, request: Any, context: Context) -> AsyncIterator[BackendOutput]:
        req = request if isinstance(request, PreprocessedRequest) else (
            PreprocessedRequest.from_obj(request)
        )
        prompt = self._check_request(req)
        self._ensure_loop()
        if (req.annotations or {}).get("op") == "embed":
            vec = await self._embed(list(req.token_ids))
            yield BackendOutput(finish_reason=FINISH_STOP, annotations={
                "embedding": [float(v) for v in vec], "input_tokens": len(req.token_ids)})
            return
        ann = req.annotations or {}
        guided_tables, guided_state = None, 0
        if req.sampling.guided is not None and self.guided_enabled:
            guided_tables, guided_state = await self._request_grammar(req)
        # an adapter request's blocks are salted with the adapter's load:
        # the K/V of every layer after a LoRA target depends on it
        extra_key = self.lora.cache_key(ann.get("lora")) if self.lora is not None else None
        st = _Seq(
            req=req, context=context, out_queue=asyncio.Queue(),
            seq=TokenBlockSequence(prompt, self.cfg.block_size, extra_key=extra_key),
            last_token=prompt[-1], guided_tables=guided_tables, guided_state=guided_state,
        )
        s = req.sampling
        st.spec_ok = self._spec and (s.temperature == 0.0 and s.logprobs == 0
                                     and not _has_penalties(s)
                                     and not ann.get("logits_processors")
                                     and guided_tables is None)
        if (req.annotations or {}).get("images"):
            loop = asyncio.get_running_loop()
            embeds, mask = await loop.run_in_executor(self._executor, self._encode_images, req)
            # prior_token_ids extend the prompt past token_ids: generated
            # text is never an image span
            extra = len(prompt) - len(mask)
            st.mm_embeds = np.concatenate([embeds, np.zeros((extra, embeds.shape[1]),
                                                            np.float32)])
            st.mm_mask = np.concatenate([mask, np.zeros(extra, bool)])
            st.no_cache = True
        if req.kv_transfer and req.kv_transfer.get("address") and not st.no_cache:
            # disaggregated decode: the prefill worker's pages first, so
            # that admission finds them as a cached prefix
            await self._import_transferred(req)
        if self.kvbm is not None and not st.no_cache:
            # a tier miss or a foreign block format is a miss; a kernel or
            # device error raises to the caller (no silent recompute)
            await self._onboard_from_kvbm(st)
        st.sla = spec_from_annotations(ann)
        st.t_queued = time.time_ns()
        queued: Dict[str, Any] = dict(prompt_tokens=len(prompt), waiting=len(self._waiting))
        if st.sla is not None:
            # the promise rides the queued event: /debug/requests?id= reads
            # the budget breakdown from it (runtime/slo.py)
            queued.update(sla_class=st.sla.sla_class, ttft_target_s=st.sla.ttft_target_s,
                          itl_target_s=st.sla.itl_target_s, deadline_s=st.sla.deadline_s)
        get_flight_recorder().record(req.request_id, "queued", **queued)
        self._waiting.append(st)
        self._idle = False
        self._wake.set()
        # disaggregated prefill: the finish carries the pages' address
        prefill_side = ann.get("disagg") == "prefill"
        while True:
            item = await st.out_queue.get()
            if (prefill_side and item.finish_reason is not None
                    and self.transfer_address is not None and not st.no_cache):
                prompt_blocks = len(req.token_ids) // self.cfg.block_size
                item.kv_transfer = {
                    "address": self.transfer_address,
                    "hashes": [int(h) for h in st.seq.sequence_hashes()[:prompt_blocks]],
                    "num_tokens": prompt_blocks * self.cfg.block_size,
                    # this server speaks the block-window protocol
                    "stream": True,
                }
            if item.finish_reason is not None:
                # before the last yield: a consumer that returns at the
                # finish closes this generator at the yield
                self._request_finished(st, item.finish_reason)
            yield item
            if item.finish_reason is not None:
                return

    async def _request_grammar(self, req: PreprocessedRequest):
        """(token tables, FSM state) of a request's grammar: compiled (or
        taken from the cache), and walked past ``prior_token_ids`` (tokens
        a request resumed elsewhere already generated). A ``soft`` grammar
        that fails to compile is served unconstrained: (None, 0)."""
        spec = req.sampling.guided
        try:
            tables = await self._compile_guided(spec)
        except ValueError:
            if not spec.get("soft"):
                raise
            log.warning("soft guided grammar rejected; serving unconstrained")
            return None, 0
        state = 0
        if req.prior_token_ids:
            try:
                state = tables.walk(0, [int(t) for t in req.prior_token_ids])
            except ValueError as e:
                raise GuidedRejectedError(
                    f"prior tokens violate the guided grammar: {e}") from e
        return tables, state

    async def _compile_guided(self, spec: Dict[str, Any]):
        """Grammar spec -> TokenTables, compiled on the guided thread (off
        the event loop and off the step thread) and cached by content: the
        in-flight future, so that a burst of requests with one schema
        compiles it once. An automaton over ``guided_max_states`` is
        refused before anything vocab-sized is built; tables whose classes
        reach ``guided_max_classes`` are refused too (the last column is the
        always-reject class of model ids past the tokenizer's vocabulary).
        Raises GuidedRejectedError; a failure is not cached."""
        cfg = self.cfg
        key = json.dumps(spec, sort_keys=True, default=str)

        def compile_():
            pattern = guided_regex_pattern(spec.get("kind"), spec.get("value"))
            # subset construction can overshoot before minimization shrinks
            # it, so construction gets headroom over the cap; the minimized
            # count is held to the cap before the token product
            dfa = compile_regex(pattern, max_states=min(32768, 32 * cfg.guided_max_states))
            if dfa.num_states > cfg.guided_max_states:
                raise ValueError(f"guided grammar needs {dfa.num_states} states > engine "
                                 f"cap {cfg.guided_max_states}")
            tt = build_token_tables(dfa, self._g_vocab, self._g_eos)
            if tt.num_classes >= cfg.guided_max_classes:
                raise ValueError(f"guided grammar needs {tt.num_classes} token classes "
                                 f">= engine cap {cfg.guided_max_classes}")
            return tt

        loop = asyncio.get_running_loop()
        task = self._g_cache.get(key)
        if task is None:
            task = asyncio.ensure_future(loop.run_in_executor(self._guided_executor, compile_))
            if len(self._g_cache) > 32:
                self._g_cache.pop(next(iter(self._g_cache)))
            self._g_cache[key] = task
        try:
            return await asyncio.shield(task)
        except (RegexError, SchemaError, ValueError) as e:
            if self._g_cache.get(key) is task:
                del self._g_cache[key]
            raise GuidedRejectedError(f"guided grammar rejected: {e}") from e

    async def _embed(self, token_ids: List[int]) -> np.ndarray:
        """Queue an embedding for the loop, which serves it between steps
        (never while a horizon is in flight), and wait for its vector."""
        fut = asyncio.get_running_loop().create_future()
        self._embed_waiting.append((token_ids, fut))
        self._idle = False
        self._wake.set()
        return await fut

    async def _serve_embeds(self, loop) -> None:
        """Loop thread: run the queued embeddings on the step executor. An
        input longer than one prefill chunk gets temporary pages for its
        chunks (allocated here, where the allocator lives; never committed
        to the prefix cache, never offloaded, released after)."""
        pending, self._embed_waiting = self._embed_waiting, []
        for token_ids, fut in pending:
            if fut.done():
                continue
            S, block_ids = len(token_ids), None
            if S > self.cfg.prefill_chunk:
                need = -(-S // self.cfg.block_size)
                if not self.allocator.can_allocate(need):
                    fut.set_exception(ValueError(
                        f"no KV capacity for a {S}-token embedding ({need} blocks needed); "
                        "retry later"))
                    continue
                block_ids = self.allocator.allocate(need)
            try:
                vec = await loop.run_in_executor(self._executor, self._op["embed"],
                                                 token_ids, block_ids)
            except Exception as e:
                if not fut.done():
                    fut.set_exception(e)
            else:
                if not fut.done():
                    fut.set_result(vec)
            finally:
                if block_ids is not None:
                    self.allocator.release(block_ids)

    def _ensure_loop(self) -> None:
        if self._loop_task is None or self._loop_task.done():
            self._loop_task = asyncio.get_running_loop().create_task(self._loop())

    def stop(self) -> None:
        if self._loop_task is not None:
            self._loop_task.cancel()
        if self._mh is not None and self.is_leader:
            # the followers replay what was broadcast before it, then exit
            self._mh.router.close()
        if self._transfer_server is not None or self._transfer_client is not None:
            try:
                loop = asyncio.get_running_loop()
            except RuntimeError:
                loop = None   # no running loop: the sockets close with us
            if loop is not None:
                if self._transfer_server is not None:
                    spawn_bg(self._transfer_server.stop(0.5))
                if self._transfer_client is not None:
                    spawn_bg(self._transfer_client.close())
        if self._kv_transfer_srv is not None:
            from .transfer import LOCAL_SERVERS

            self._kv_transfer_srv.close()
            LOCAL_SERVERS.pop(self.transfer_address, None)
        self._executor.shutdown(wait=False)
        self._fetch_executor.shutdown(wait=False)
        self._offload_executor.shutdown(wait=False)
        if self.guided_enabled:
            self._guided_executor.shutdown(wait=False)
        if self._prep is not None:
            self._prep.stop()

    # ------------------------------------------------------------ step loop
    async def _loop(self) -> None:
        loop = asyncio.get_running_loop()
        try:
            while True:
                if (not self._waiting and not self._chains and not self._embed_waiting
                        and all(s is None for s in self._slots)):
                    self._wake.clear()
                    self._idle = True
                    await self._park()
                    self._idle = False
                # chaos drill hook: an armed engine.step fault crashes the
                # loop through the real crash path below (the requests
                # finish with an error, on_crash, the watchdog deregisters);
                # a no-op unarmed
                await FAULTS.ainject("engine.step")
                if self._embed_waiting and not self._chains:
                    await self._serve_embeds(loop)
                self._admit_cancelled()
                self._try_admit()
                # chunked prefill: ONE bounded chunk per tick, round-robin
                # over prefilling sequences
                prefilling = [
                    s for s in self._slots
                    if s is not None and not s.done and not s.prefilled
                ]
                did_mixed = False
                mixed_blocked = False
                if prefilling:
                    pick = prefilling[self._prefill_rr % len(prefilling)]
                    self._prefill_rr += 1
                    if pick.context.is_stopped():
                        pick.done = True
                        pick.out_queue.put_nowait(BackendOutput(
                            finish_reason=FINISH_CANCELLED,
                            cumulative_tokens=pick.produced,
                        ))
                    else:
                        if pick.t_prefill_start == 0:
                            pick.t_prefill_start = time.time_ns()
                        chunk_from = pick.prefill_pos
                        # the fused mixed step, when decode rows are resident
                        # and no horizon is in flight (its carry would
                        # predate the fused step's cache writes); never on a
                        # vision engine
                        mixed_seqs = None
                        if not self._chains and self.mixed_enabled:
                            snap = self._decode_snapshot()
                            if any(s is not None for s in snap):
                                if self._book_decode_blocks(snap, 1):
                                    mixed_seqs = snap
                                else:
                                    # no pages: this chunk runs split, and
                                    # horizons go on rather than wait for a
                                    # fused step that cannot book
                                    mixed_blocked = True
                        t_step = time.perf_counter()
                        results = []
                        if mixed_seqs is not None:
                            results, first = await loop.run_in_executor(
                                self._executor, self._run_mixed_step, pick, mixed_seqs
                            )
                            did_mixed = True
                            for acc in results:
                                self._accept_token(*acc)
                        else:
                            first = await loop.run_in_executor(
                                self._executor, self._run_prefill_chunk, pick
                            )
                        self._commit_prefilled_blocks(pick)
                        if first is not None:
                            pick.prefilled = True
                            self._accept_token(*first)
                        self._step_stats("mixed" if did_mixed else "prefill",
                                         time.perf_counter() - t_step,
                                         (pick.prefill_pos - chunk_from) + len(results))
                has_active = any(s is not None for s in self._decode_snapshot())
                # top up the horizon pipeline before fetching the oldest
                # results, so that the readback overlaps the horizons in
                # flight. While a prefill that the mixed step could carry is
                # in progress, no horizon is dispatched: the chains in
                # flight drain, then each tick runs one fused step. (A
                # prefill's first token is applied at once here, so a
                # prefill that just ended no longer holds horizons back.)
                prefilling = [s for s in prefilling if not s.done and not s.prefilled]
                mixed_wait = (bool(prefilling) and has_active and not mixed_blocked
                              and self.mixed_enabled)
                while (
                    has_active
                    and not self._waiting
                    and not self._embed_waiting
                    and not did_mixed
                    and not mixed_wait
                    and len(self._chains) < self.cfg.decode_pipeline
                    and (not self._chains or self._can_chain(self._chains[-1]))
                    and self._prepare_horizon(depth=len(self._chains) + 1)
                ):
                    prev = self._chains[-1] if self._chains else None
                    chain = await loop.run_in_executor(
                        self._executor, self._dispatch_horizon, prev, self._decode_snapshot()
                    )
                    self._chains.append(chain)
                if self._chains:
                    chain = self._chains.popleft()
                    t_step = time.perf_counter()
                    # shielded: a cancelled loop leaves the fetch to run
                    # (its tokens still enter sampled_digest)
                    packed = await asyncio.shield(asyncio.wrap_future(chain.fetch))
                    before = sum(st.produced for st in chain.seqs if st is not None)
                    self._apply_packed(chain, packed)
                    self._step_stats(
                        "decode", time.perf_counter() - t_step,
                        sum(st.produced for st in chain.seqs if st is not None) - before,
                        passes=(self._spec_rounds if chain.spec else self.cfg.decode_steps))
                elif has_active and not did_mixed:
                    t_step = time.perf_counter()
                    results = await loop.run_in_executor(
                        self._executor, self._run_decode, self._decode_snapshot()
                    )
                    for acc in results:
                        self._accept_token(*acc)
                    self._step_stats("decode", time.perf_counter() - t_step, len(results))
                self._reap_finished()
                if self.kvbm is not None:
                    await self._offload_ready_blocks()
                await self._publish_events()
                await asyncio.sleep(0)
        except Exception as crash:
            log.exception("engine loop crashed")
            self.healthy = False
            if self.on_crash is not None:
                spawn_bg(self.on_crash(crash))
            for st in list(self._waiting) + [s for s in self._slots if s]:
                st.done = True
                evac = self._evacuation_plan(st)
                st.out_queue.put_nowait(BackendOutput(
                    finish_reason=FINISH_ERROR, cumulative_tokens=st.produced,
                    annotations={"evacuation": evac} if evac else {},
                ))
                if st.block_ids:
                    self.allocator.release(st.block_ids)
            self._waiting = []
            for _, fut in self._embed_waiting:
                if not fut.done():
                    fut.set_exception(RuntimeError("engine loop crashed"))
            self._embed_waiting = []
            self._slots = [None] * self.cfg.max_batch_size
            self._chains.clear()
            self._sealed_unwritten = []

    async def _publish_events(self) -> None:
        """Drain the allocator's stored / removed events (and KVBM's
        evictions) every tick, publish them when a KV publisher is
        attached, and publish the load whenever it changed. The publishers
        queue their frames (the event plane's writer sends them), so this
        never waits on the network."""
        stored, removed = self.allocator.drain_events()
        evicted = self.kvbm.drain_evicted() if self.kvbm is not None else []
        if self.kv_directory is not None and self.kvbm is not None:
            await self._directory_upkeep(evicted)
        if self.kv_publisher is not None:
            removed = await self._publish_kv_events(stored, removed, evicted)
        # on KV events AND whenever the load changed: releases emit no
        # events, and a stale active-block report would leave the router
        # seeing phantom load on an idle worker
        await self.publish_load(force=bool(stored or removed))

    async def _park(self) -> None:
        """Wait for work. With a KV directory attached, the offloads that
        reach the tiers after the last tick (the offload thread finishes
        behind the loop) are advertised twice a second while the loop is
        parked, not at the next request's first tick."""
        while self.kv_directory is not None and self.kvbm is not None:
            try:
                await asyncio.wait_for(self._wake.wait(), 0.5)
                return
            except asyncio.TimeoutError:
                await self._publish_events()
        await self._wake.wait()

    async def _directory_upkeep(self, evicted: List[int]) -> None:
        """The global KV directory on the tick's consolidated events:
        advertise the blocks newly offloaded to a local tier, by tier, and
        withdraw the evicted ones no device page holds either. A directory
        fault (an armed ``directory.publish`` too) never stalls the loop:
        the entries' TTL and lease age out what a failed withdraw left."""
        by_hash = self.allocator._by_hash
        gone = [h for h in evicted if by_hash.get(h) is None]
        try:
            by_tier: Dict[str, List[int]] = {}
            for h in self.kvbm.drain_stored():
                t = self.kvbm.tier_of(h)
                if t is not None:
                    by_tier.setdefault(t, []).append(h)
            fmt = "int8" if self.kv_quantized else "model"
            for t, hs in sorted(by_tier.items()):
                await self.kv_directory.publish(hs, t, fmt)
            if gone:
                await self.kv_directory.unpublish(gone)
        except Exception:
            log.warning("kv directory upkeep failed (continuing)", exc_info=True)

    async def publish_load(self, force: bool = False) -> None:
        """Publish the load, and a LoRA engine's adapter keys, when they
        changed since the last report (or ``force``). The worker calls it
        after an adapter load or unload, which may come while the loop
        idles: the KV router needs the new key before the adapter's next
        request."""
        if self.metrics_publisher is None:
            return
        running = sum(1 for s in self._slots if s is not None and not s.done)
        adapters = self.lora.key_map() if self.lora is not None else None
        load = (self.allocator.active_blocks, len(self._waiting), running, adapters)
        if force or load != self._last_published_load:
            self._last_published_load = load
            await self.metrics_publisher.publish(
                active_decode_blocks=load[0],
                num_requests_waiting=load[1],
                num_requests_active=running,
                total_blocks=self.cfg.num_blocks,
                adapters=adapters,
            )

    async def _publish_kv_events(self, stored, removed, evicted) -> list:
        """Publish one tick's stored and removed batches; returns the
        removed batches that went out. With KVBM, a block evicted from the
        device pool that a tier still serves is not reported removed (the
        router's view is of every tier, as the reference's consolidated
        events), and a block gone from every tier and from the device pool
        is.

        The removals go out before the stores, and a block stored and gone
        again within the tick is removed once more after them: a prompt's
        admission can evict a cached block that its own prefill then
        commits again, and the reference's order (stores, then removals)
        leaves such a block out of the router's view."""
        by_hash = self.allocator._by_hash
        # stored and gone again within the tick: removed once more at the end
        again = [h for batch in stored for h in batch if h not in by_hash] if removed else []
        if self.kvbm is not None:
            gone = [h for h in evicted if by_hash.get(h) is None]
            if gone:
                removed = removed + [gone]
            loop = asyncio.get_running_loop()

            async def unservable(batch):
                servable = set(await loop.run_in_executor(
                    None, self.kvbm.filter_servable, batch))
                return [h for h in batch if h not in servable]

            removed = [b for b in [await unservable(b) for b in removed] if b]
            again = await unservable(again) if again else again
        for batch in removed:
            await self.kv_publisher.removed(batch)
        for batch in stored:
            await self.kv_publisher.stored(batch)
        if again:
            await self.kv_publisher.removed(again)
        return removed

    def _admit_cancelled(self) -> None:
        keep = []
        for st in self._waiting:
            if st.context.is_stopped():
                st.out_queue.put_nowait(
                    BackendOutput(finish_reason=FINISH_CANCELLED, cumulative_tokens=0)
                )
            else:
                keep.append(st)
        self._waiting = keep

    def _free_slot(self) -> int:
        for i, s in enumerate(self._slots):
            if s is None:
                return i
        return -1

    def _try_admit(self) -> None:
        still: List[_Seq] = []
        bs = self.cfg.block_size
        for st in self._waiting:
            slot = self._free_slot()
            if slot < 0:
                still.append(st)
                continue
            prompt_len = len(st.seq)
            hashes = st.seq.sequence_hashes()
            # reuse at most the blocks strictly before the last prompt token,
            # so prefill always has >= 1 token to produce logits from
            reusable = 0 if st.no_cache else min(len(hashes), (prompt_len - 1) // bs)
            prefix_ids = self.allocator.acquire_prefix(hashes[:reusable])
            blocks_needed = (prompt_len + bs - 1) // bs - len(prefix_ids)
            try:
                new_ids = self.allocator.allocate(blocks_needed)
            except OutOfBlocks:
                self.allocator.release(prefix_ids)
                still.append(st)
                continue
            st.block_ids = prefix_ids + new_ids
            st.cached_tokens = len(prefix_ids) * bs
            # prompt blocks become content-addressed only as their chunks'
            # KV is written (_commit_prefilled_blocks)
            st.commit_upto = len(prefix_ids)
            st.prefill_pos = st.cached_tokens
            st.slot = slot
            self._slots[slot] = st
            st.t_admitted = time.time_ns()
            get_flight_recorder().record(st.req.request_id, "admitted", slot=slot,
                                         cached_tokens=st.cached_tokens,
                                         prompt_tokens=prompt_len)
            self._block_tables[slot].fill(0)
            self._block_tables[slot, : len(st.block_ids)] = st.block_ids
            s = st.req.sampling
            seed = int(s.seed if s.seed is not None else self._host_rng.integers(1 << 32))
            ann = st.req.annotations or {}
            self._lora_slots[slot] = (self.lora.slot_of(ann.get("lora"))
                                      if self.lora is not None else 0)
            wanted = ann.get("logits_processors") or []
            self._lp_masks[slot] = False
            for k, (pname, _fn) in enumerate(self._procs):
                self._lp_masks[slot, k] = pname in wanted
            if self.guided_enabled:
                self._admit_guided(st, slot)
            # penalty tables: reset the slot's rows when this request uses
            # penalties or processors (which read the output counts, as
            # the reference's counts_need) or a prior occupant left them
            # dirty
            has_pen = _has_penalties(s)
            st.counting = has_pen or bool(wanted)
            row = None
            if st.counting or self._slot_dirty[slot]:
                row = np.zeros(self.mcfg.vocab_size, np.int8)
                if has_pen:
                    ids = np.asarray(st.seq.tokens(), np.int64)
                    # image placeholders sit above the vocab: they are not
                    # sampleable, so they do not enter the mask
                    row[ids[ids < self.mcfg.vocab_size]] = 1
            self._op["admit"](slot, s.temperature, s.top_k, s.top_p, s.min_p,
                              s.presence_penalty, s.frequency_penalty, s.repetition_penalty,
                              min(max(s.logprobs, 0), TOP_LOGPROBS_K), seed, row)
            # counts accumulate for every active slot while anyone counts: a
            # slot that shared a batch with a counting request holds stale
            # counts the next occupant must not inherit
            self._slot_dirty[slot] = st.counting or any(
                o is not None and o.counting for o in self._slots if o is not st
            )
            if st.counting:
                for j, other in enumerate(self._slots):
                    if other is not None and other is not st:
                        self._slot_dirty[j] = True
        self._waiting = still

    def _dev_admit(self, slot: int, temperature: float, top_k: int, top_p: float,
                   min_p: float, presence: float, frequency: float, repetition: float,
                   logprobs: int, seed: int, row: Optional[np.ndarray]) -> None:
        """Device op of an admission: the slot's sampling parameters (host
        arrays every rank keeps, which the eager steps read) and, with
        ``row`` (the prompt's token mask, int8 [V]), its penalty rows
        reset: the mask written, the output counts zeroed."""
        self._temps[slot] = temperature
        self._top_ks[slot] = top_k
        self._top_ps[slot] = top_p
        self._min_ps[slot] = min_p
        self._pres[slot] = presence
        self._freqs[slot] = frequency
        self._reps[slot] = repetition
        self._lp_ns[slot] = logprobs
        self._seeds[slot] = seed
        if row is not None:
            self.prompt_masks[slot] = self._t(row)
            self.output_counts[slot] = 0

    def _admit_guided(self, st: _Seq, slot: int) -> None:
        """Write a guided request's token tables into its slot's rows of the
        device tables, in place (the horizon's graphs hold their addresses):
        model ids past the tokenizer's vocabulary map to column C of the
        transitions, which stays all -1 (always rejected). A request
        without a grammar only clears the slot's guided flag."""
        tt = st.guided_tables
        self._g_active[slot] = tt is not None
        if tt is None:
            return
        c, V = self.cfg, self.mcfg.vocab_size
        S_g, C_g = tt.trans.shape
        n = min(len(tt.class_of), V)
        cls = np.full(V, C_g, np.int32)
        cls[:n] = tt.class_of[:n]
        trans = np.full((c.guided_max_states, c.guided_max_classes), -1, np.int32)
        trans[:S_g, :C_g] = tt.trans
        self.g_class[slot].copy_(torch.from_numpy(cls))
        self.g_trans[slot].copy_(torch.from_numpy(trans))
        self._g_state[slot] = st.guided_state

    def _feature_rows(self, seqs: List[Optional[_Seq]]) -> bool:
        """Whether any active row of a dispatch uses a per-request feature
        (an adapter, a processor, a grammar)."""
        return any(st is not None and (self._lora_slots[i] != 0 or self._lp_masks[i].any()
                                       or self._g_active[i])
                   for i, st in enumerate(seqs))

    def _bucket(self, n: int) -> int:
        for b in self.cfg.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(
            f"prefill of {n} tokens exceeds largest bucket {self.cfg.prefill_buckets[-1]}"
        )

    def _commit_prefilled_blocks(self, st: _Seq) -> None:
        """Content-address the prompt blocks whose KV the last chunk wrote:
        only written blocks ever become matchable (never a multimodal
        prompt's)."""
        if st.no_cache:
            return
        hashes = st.seq.sequence_hashes()
        upto = min(st.prefill_pos // self.cfg.block_size, len(hashes))
        for i in range(st.commit_upto, upto):
            self.allocator.commit(st.block_ids[i], hashes[i])
            if self.kvbm is not None:
                self._offload_pending.append((st.block_ids[i], hashes[i], 0))
        if upto > st.commit_upto and self.kv_commits is not None:
            # wake streamed fetches: this chunk's blocks are addressable
            self.kv_commits.fire()
        st.commit_upto = max(st.commit_upto, upto)

    def _decode_snapshot(self) -> List[Optional[_Seq]]:
        return [
            st if (st is not None and not st.done and st.prefilled) else None
            for st in self._slots
        ]

    def _book_decode_blocks(self, seqs: List[Optional[_Seq]], extra_tokens: int) -> bool:
        """Give every active sequence in ``seqs`` pages for ``extra_tokens``
        more decode tokens; all-or-nothing (what one call took is given back
        on failure)."""
        bs = self.cfg.block_size
        granted: List[Tuple[_Seq, int]] = []
        ok = True
        for st in seqs:
            if st is None or st.done or not st.prefilled:
                continue
            L = len(st.seq)
            if L + extra_tokens >= self.cfg.max_context:
                ok = False
                break
            extra = (L + extra_tokens) // bs + 1 - len(st.block_ids)
            if extra > 0:
                try:
                    new_ids = self.allocator.allocate(extra)
                except OutOfBlocks:
                    ok = False
                    break
                base = len(st.block_ids)
                st.block_ids.extend(new_ids)
                self._block_tables[st.slot, base:base + extra] = new_ids
                granted.append((st, extra))
        if not ok:
            for st, count in granted:
                taken = st.block_ids[-count:]
                del st.block_ids[-count:]
                self._block_tables[st.slot, len(st.block_ids):len(st.block_ids) + count] = 0
                self.allocator.release(taken)
        return ok

    def _prepare_horizon(self, depth: int = 1) -> bool:
        """Book pages so that every decoding sequence can absorb ``depth``
        more horizons (depth 2 when dispatching on top of one in flight).
        False: no horizon this tick (decode_steps 1, too few pages, or a
        sequence within reach of max_context); the loop runs one step."""
        n = self.cfg.decode_steps
        if n <= 1:
            return False
        return self._book_decode_blocks(self._slots, depth * n)

    def _can_chain(self, chain: _Chain) -> bool:
        """A horizon may start from ``chain``'s device carry only if every
        decoding slot holds the sequence it held at that dispatch: a
        sequence admitted into a recycled slot would decode from a stale
        carry."""
        for i, st in enumerate(self._slots):
            if (st is not None and not st.done and st.prefilled
                    and chain.seqs[i] is not st):
                return False
        return True

    # ------------------------------------------------ device work (executor)
    def _t(self, arr, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(arr), dtype=dtype, device=self.device)

    def _chunk_arrays(self, token_ids: List[int], start: int, chunk_len: int,
                      block_ids: List[int]):
        """One prefill chunk's padded host arrays: (tokens [S_pad], positions
        [S_pad], new_block_ids [S_pad // bs]). Pad positions pin to
        max_context - 1, pad rows write scratch block 0."""
        bs = self.cfg.block_size
        S_pad = self._bucket(chunk_len)
        tokens = np.zeros(S_pad, np.int64)
        tokens[:chunk_len] = token_ids[start:start + chunk_len]
        positions = np.full(S_pad, self.cfg.max_context - 1, np.int64)
        positions[:chunk_len] = np.arange(start, start + chunk_len)
        new_block_ids = np.zeros(S_pad // bs, np.int64)
        real = block_ids[start // bs:][: S_pad // bs]
        new_block_ids[: len(real)] = real
        return tokens, positions, new_block_ids

    def _next_chunk(self, st: _Seq):
        """(start, chunk_len, is_final, host arrays, device tensors or None)
        of st's next prefill chunk: the prep thread's prebuild when it
        matches exactly (engine/prep.py), else packed here."""
        prompt = st.seq.tokens()
        start = st.prefill_pos
        remaining = len(prompt) - start
        is_final = remaining <= self.cfg.prefill_chunk
        chunk_len = remaining if is_final else self.cfg.prefill_chunk
        got = None
        if self._prep is not None:
            got = self._prep.take(st.req.request_id, prompt, start, chunk_len, st.block_ids)
        arrays, dev = got if got is not None else (
            self._chunk_arrays(prompt, start, chunk_len, st.block_ids), None)
        return start, chunk_len, is_final, arrays, dev

    def _schedule_next_chunk(self, st: _Seq, is_final: bool) -> None:
        """Step executor, right after a chunk's forward is enqueued (the
        device runs it from here): hand the NEXT chunk's packing and copy
        to the prep thread, so they run under this chunk's device work."""
        if self._prep is None or is_final:
            return
        prompt = st.seq.tokens()
        remaining = len(prompt) - st.prefill_pos
        if remaining <= 0:
            return
        self._prep.schedule(st.req.request_id, prompt, st.prefill_pos,
                            min(remaining, self.cfg.prefill_chunk), st.block_ids)

    def _prep_upload(self, arr: np.ndarray) -> torch.Tensor:
        """Prep thread: one chunk array on the device. On CUDA the copy
        goes from pinned memory onto the step executor's stream, so it is
        ordered before the dispatch that reads it; PyTorch's pinned-memory
        allocator holds the host buffer until the copy has run."""
        host = torch.from_numpy(arr)
        if self._stream is None:
            return host
        with torch.cuda.stream(self._stream):
            return host.pin_memory().to(self.device, non_blocking=True)

    def _chunk_table(self, st: _Seq, total_len: int) -> np.ndarray:
        """The sequence's block table cut to the pages holding keys <
        total_len (the attention never reads past them)."""
        n = -(-total_len // self.cfg.block_size)
        return self._block_tables[st.slot, :n]

    def _dev(self, x, dtype=None) -> torch.Tensor:
        """An op argument on the device: a host array copied there, a
        tensor (a prebuilt chunk's) as it is."""
        return x if isinstance(x, torch.Tensor) else self._t(x, dtype)

    def _ragged(self, q, kc, vc, tables, rows, max_q_len: int, max_seq_len: int,
                attrs: dict) -> torch.Tensor:
        """One ragged launch of the main model over ``rows`` (q_starts,
        q_lens, seq_lens): the latent kernel for an MLA model (its first
        kv_lora_rank output lanes, read from the one latent cache: V'
        equals K' there), else the unified kernel (``_unified``)."""
        if self._latent:
            return cuda_mla.latent_paged_attention(
                q, kc, tables, *rows, v_dim=self.mcfg.kv_lora_rank, max_q_len=max_q_len,
                max_seq_len=max_seq_len)
        return self._unified(q, kc, vc, tables, rows, max_q_len, max_seq_len, attrs)

    @staticmethod
    def _unified(q, kc, vc, tables, rows, max_q_len: int, max_seq_len: int,
                 attrs: dict) -> torch.Tensor:
        """One launch of the unified kernel over ``rows`` with the layer's
        attention attributes (a draft's windowed layers take it directly:
        a draft is never MLA)."""
        return cuda_unified.ragged_paged_attention(
            q, kc, vc, tables, *rows, max_q_len=max_q_len, max_seq_len=max_seq_len, **attrs)

    @torch.inference_mode()
    def _run_prefill_chunk(self, st: _Seq) -> Optional[Accepted]:
        """Prefill ONE bounded chunk of st's prompt; the final chunk also
        samples the first token (returned), earlier ones return None."""
        start, chunk_len, is_final, arrays, dev = self._next_chunk(st)
        total_len = start + chunk_len
        got = self._op["prefill"](
            *(dev if dev is not None else arrays), self._chunk_table(st, total_len), start,
            chunk_len, int(self._lora_slots[st.slot]),
            *self._mm_args(st, start, chunk_len, len(arrays[0])),
            self._first_args(st) if is_final else None)
        st.prefill_pos = total_len
        self._schedule_next_chunk(st, is_final)
        self._advance_draft_prefill(st)
        return None if got is None else (st, *got)

    @torch.inference_mode()
    def _dev_prefill(self, tokens, positions, new_ids, table, start: int, chunk_len: int,
                     lora_id: int, mm_embeds, mm_mask, first: Optional[np.ndarray]):
        """Device op of a prefill chunk: its padded arrays (tokens,
        positions, the pages its rows write), its block table, the vision
        splice's soft tokens and mask (None on a text engine) and, on the
        final chunk, the first token's sampling (``_first_args``). Returns
        the first token's (token, logprob, top ids, top values), or None."""
        new_ids_t = self._dev(new_ids)
        attend = self._chunk_attend(self._t(table, torch.int32), start, chunk_len,
                                    len(tokens), new_ids_t)
        ids, embeds = self._splice(self._dev(tokens), mm_embeds, mm_mask)
        kw = self._lora_kw(lora_id)
        if embeds is not None:
            kw["inputs_embeds"] = embeds
        hidden = self._forward(self.params, self.mcfg, ids, self._dev(positions), attend, **kw)
        self.step_counts["prefill"] += 1
        if first is None:
            return None
        return self._first_token(hidden[chunk_len - 1:chunk_len], first)

    def _chunk_attend(self, table: torch.Tensor, start: int, chunk_len: int, S_pad: int,
                      new_ids_t: torch.Tensor):
        """The attend of one prefill chunk of ``chunk_len`` rows (padded to
        ``S_pad``) at ``start``, over the pages of ``table``: write the
        chunk's KV into its pages (``new_ids_t``), then attend over the
        context through the family's kernel."""
        total_len = start + chunk_len
        pad = self._pad_rows(chunk_len, S_pad)
        # for layers with attention attributes: the chunk as ONE ragged row
        # of the unified kernel, its segment at the tail of a total_len context
        unified = _UnifiedRows(self._t, [0], [chunk_len], [total_len])

        def attend(q, k_new, v_new, layer_idx, **extra):
            kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
            att.write_prefill_kv(kc, vc, *pad(k_new, v_new), new_ids_t)
            if extra or self._latent:
                return self._ragged(q, kc, vc, table[None], unified.rows(), chunk_len,
                                    unified.max_seq_len, unified.attrs(**extra))
            if self.kv_quantized:
                # raw int8 context + per-position scales: the kernel
                # dequantizes in registers (half the context bytes of bf16)
                kq, vq, ks, vs = att.gather_kv_quant(kc, vc, table)
                return cuda_prefill.flash_extend_attention(
                    q, kq, vq, start, total_len, k_scales=ks, v_scales=vs)
            k_ctx, v_ctx = att.gather_kv(kc, vc, table)
            return cuda_prefill.flash_extend_attention(q, k_ctx, v_ctx, start, total_len)

        return attend

    @torch.inference_mode()
    def _run_embed(self, token_ids: List[int],
                   block_ids: Optional[List[int]] = None) -> np.ndarray:
        """Step executor: the pooled forward of an embedding request, the
        last token's final hidden state in float32, L2-normalised (norm
        floored at 1e-9), as the reference's. An input that fits one
        prefill bucket (``block_ids`` None) runs one forward whose
        attention reads the chunk's own K/V, unquantized, in no page of
        the pool: flash-extend over it for the llama family, else its rows
        viewed as pages of their own for the unified or the latent kernel.
        A longer one runs as prefill chunks over the temporary pages
        ``block_ids``, through the prefill chunk's attend."""
        S, bs = len(token_ids), self.cfg.block_size
        if block_ids is None:
            S_pad = self._bucket(S)
            tokens = np.zeros(S_pad, np.int64)
            tokens[:S] = token_ids
            attend, last = self._own_kv_attend(S, S_pad), S - 1
            hidden = self._forward(self.params, self.mcfg, self._t(tokens),
                                   self._t(np.arange(S_pad)), attend)
            self.step_counts["embed"] += 1
        else:
            for start in range(0, S, self.cfg.prefill_chunk):
                chunk_len = min(self.cfg.prefill_chunk, S - start)
                tokens, positions, new_ids = self._chunk_arrays(token_ids, start, chunk_len,
                                                                block_ids)
                table = self._t(block_ids[:-(-(start + chunk_len) // bs)], torch.int32)
                attend = self._chunk_attend(table, start, chunk_len, len(tokens),
                                            self._t(new_ids))
                hidden = self._forward(self.params, self.mcfg, self._t(tokens),
                                       self._t(positions), attend)
                self.step_counts["embed"] += 1
            last = chunk_len - 1
        h = hidden[last].float()
        return (h / torch.clamp(torch.linalg.vector_norm(h), min=1e-9)).cpu().numpy()

    def probe_collectives(self, reps: int = 20) -> Dict[str, float]:
        """Seconds of one all-reduce of a decode step's [max_batch_size,
        hidden] activations in the model dtype and of one gather of its
        logits' vocabulary shards, each the median of ``reps`` calls on
        every rank of the group (a device op: the followers take part)."""
        if self.comm is None:
            raise RuntimeError("probe_collectives needs a TP group (tp > 1)")
        return self._op["probe_collectives"](reps)

    def _dev_probe_collectives(self, reps: int) -> Dict[str, float]:
        B, m = self.cfg.max_batch_size, self.mcfg
        x = torch.ones((B, m.hidden_size), dtype=m.dtype, device=self.device)
        part = torch.ones((B, m.vocab_size // self.tp), dtype=torch.float32,
                          device=self.device)
        out = {}
        for name, fn in (("all_reduce_s", lambda: self.comm.all_reduce(x)),
                         ("logits_gather_s", lambda: self.comm.all_gather(part))):
            fn()   # warm
            _sync(self.device)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn()
                _sync(self.device)
                times.append(time.perf_counter() - t0)
            out[name] = sorted(times)[len(times) // 2]
        return out

    def _own_kv_attend(self, n: int, S_pad: int):
        """The attend of a one-forward embedding of ``n`` tokens padded to
        ``S_pad``: causal attention over the forward's own K/V, which no
        cache holds."""
        bs = self.cfg.block_size
        rows = _UnifiedRows(self._t, [0], [n], [n])
        table = torch.arange(S_pad // bs, dtype=torch.int32, device=self.device)[None]

        def attend(q, k_new, v_new, layer_idx, **extra):
            k_new, v_new = k_new.contiguous(), v_new.contiguous()
            if not (extra or self._latent):
                return cuda_prefill.flash_extend_attention(q, k_new, v_new, 0, n)
            kc = k_new.view(S_pad // bs, bs, *k_new.shape[1:])
            vc = v_new.view(S_pad // bs, bs, *v_new.shape[1:])
            return self._ragged(q, kc, vc, table, rows.rows(), n, n, rows.attrs(**extra))

        return attend

    def _chunk_inputs(self, st: _Seq, ids: torch.Tensor, start: int, chunk_len: int):
        """(token ids, inputs_embeds or None) of a prefill chunk's forward
        from its padded ids on the device. On a vision engine the splice is
        the reference's: the ids clipped to [0, vocab) (the placeholders
        sit above it), their embeddings, and the chunk's soft tokens over
        the image positions; the forward takes the clipped ids and the
        spliced embeddings."""
        return self._splice(ids, *self._mm_args(st, start, chunk_len, len(ids)))

    def _mm_args(self, st: _Seq, start: int, chunk_len: int, S_pad: int):
        """(soft tokens, image mask) of a chunk on a vision engine, else
        (None, None)."""
        if self.cfg.vision is None:
            return None, None
        return self._mm_chunk(st, start, chunk_len, S_pad)

    def _splice(self, ids: torch.Tensor, embeds, mask):
        """The vision splice of ``_chunk_inputs`` over a chunk's soft
        tokens and mask; (ids, None) without them."""
        if embeds is None:
            return ids, None
        ids = torch.clamp(ids, 0, self.mcfg.vocab_size - 1)
        base = F.embedding(ids, self.params["embed"])
        return ids, torch.where(mask[:, None], embeds.to(base.dtype), base)

    def _mm_chunk(self, st: _Seq, start: int, chunk_len: int, S_pad: int):
        """A chunk's soft tokens [S_pad, H] (model dtype) and image mask
        [S_pad] on the device; a text-only request gets one cached zero pair
        per bucket."""
        if st.mm_embeds is None:
            if S_pad not in self._mm_zero:
                self._mm_zero[S_pad] = (
                    torch.zeros(S_pad, self.mcfg.hidden_size, dtype=self.mcfg.dtype,
                                device=self.device),
                    torch.zeros(S_pad, dtype=torch.bool, device=self.device))
            return self._mm_zero[S_pad]
        embeds = np.zeros((S_pad, self.mcfg.hidden_size), np.float32)
        mask = np.zeros(S_pad, bool)
        embeds[:chunk_len] = st.mm_embeds[start:start + chunk_len]
        mask[:chunk_len] = st.mm_mask[start:start + chunk_len]
        return self._t(embeds, self.mcfg.dtype), self._t(mask)

    @torch.inference_mode()
    def _encode_images(self, req: PreprocessedRequest) -> Tuple[np.ndarray, np.ndarray]:
        """Step executor: encode each image of the request (through the
        encoder cache) and place its patch features over the prompt's
        placeholder runs, in order. Returns (mm_embeds [L, H] float32,
        mm_mask [L]) over ``req.token_ids``."""
        vcfg = self.cfg.vision
        tokens = np.asarray(req.token_ids, np.int64)
        L = len(tokens)
        embeds = np.zeros((L, self.mcfg.hidden_size), np.float32)
        mask = tokens == self.cfg.image_token_id
        # contiguous placeholder runs, one per image
        edges = np.flatnonzero(np.diff(np.concatenate([[0], mask.astype(np.int8), [0]])))
        runs = list(zip(edges[::2].tolist(), edges[1::2].tolist()))
        images = req.annotations.get("images") or []
        if len(runs) != len(images):
            raise ValueError(f"prompt has {len(runs)} image placeholder runs but request "
                             f"carries {len(images)} images")
        for (a, b), img in zip(runs, images):
            data = img["data"]
            key = content_hash(data)
            feats = self.encoder_cache.get(key)
            if feats is None:
                arr = np.frombuffer(data, np.float32).reshape(img["shape"])
                feats = vis.encode(self.vision_params, vcfg,
                                   torch.from_numpy(arr.copy()).to(self.device))
                feats = feats.float().cpu().numpy()
                self.encoder_cache.set(key, feats)
            if b - a != feats.shape[0]:
                raise ValueError(f"image placeholder run of {b - a} tokens != "
                                 f"{feats.shape[0]} patch embeddings")
            embeds[a:b] = feats
        return embeds, mask

    def _advance_draft_prefill(self, st: _Seq) -> None:
        """Spec decoding: bring the DRAFT cache's prompt coverage up to the
        main cache's (``prefill_pos``), so that regions the main cache got
        without compute (a prefix-cache hit, a KVBM onboard) are drafted
        too; shared blocks get idempotent rewrites. Coverage only moves the
        acceptance rate. Chunks as the main prefill's, through the
        flash-extend kernel, or for a draft whose layers pass attention
        attributes (Gemma) as one ragged row of the unified kernel."""
        if not st.spec_ok:
            return
        prompt = st.seq.tokens()
        dcfg = self.cfg.spec_draft
        while st.draft_prefill_pos < st.prefill_pos:
            start = st.draft_prefill_pos
            n = min(st.prefill_pos - start, self.cfg.prefill_chunk)
            tokens, positions, new_ids = self._chunk_arrays(prompt, start, n, st.block_ids)
            table = self._t(self._chunk_table(st, start + n), torch.int32)
            new_ids_t = self._t(new_ids)
            rows = _UnifiedRows(self._t, [0], [n], [start + n])

            def attend(q, k_new, v_new, layer_idx, **extra):
                kc, vc = self.draft_k_caches[layer_idx], self.draft_v_caches[layer_idx]
                att.write_prefill_kv(kc, vc, k_new, v_new, new_ids_t)
                if extra:
                    return self._unified(q, kc, vc, table[None], rows.rows(), n,
                                         rows.max_seq_len, rows.attrs(**extra))
                k_ctx, v_ctx = att.gather_kv(kc, vc, table)
                return cuda_prefill.flash_extend_attention(q, k_ctx, v_ctx, start, start + n)

            self._draft_forward(self.draft_params, dcfg, self._t(tokens), self._t(positions),
                                attend)
            st.draft_prefill_pos = start + n

    def _pad_rows(self, chunk_len: int, S_pad: int):
        """(k, v) -> (k, v) for the chunk's KV write. An int8 cache zeroes
        the bucket-padding rows first: they share the chunk's last block
        with real rows, and their activations would enter the per-block
        quantization amax and coarsen the real tokens' scale. Pad rows are
        never attended, so zeros are safe (and exact for the amax)."""
        if not self.kv_quantized or chunk_len == S_pad:
            return lambda k, v: (k, v)
        valid = (torch.arange(S_pad, device=self.device) < chunk_len)[:, None, None]
        return lambda k, v: (torch.where(valid, k, 0.0), torch.where(valid, v, 0.0))

    @staticmethod
    def _first_args(st: _Seq) -> np.ndarray:
        """A final chunk's first-token sampling, as its op carries it:
        [slot, counting, prompt length, grammar state, temperature, top_k,
        top_p, min_p, presence, frequency, repetition] (float64: exact for
        every value here)."""
        s = st.req.sampling
        return np.array([st.slot, st.counting, len(st.seq), st.guided_state, s.temperature,
                         s.top_k, s.top_p, s.min_p, s.presence_penalty, s.frequency_penalty,
                         s.repetition_penalty], np.float64)

    def _first_token(self, hidden: torch.Tensor, first: np.ndarray):
        """Sample a prefill's first generated token from its last position
        (step 0 of the request's seeded stream); ``first`` is
        ``_first_args``. Returns (token, logprob, top ids, top values)."""
        slot, counting, seq_len, g_state, top_k = (int(first[i]) for i in (0, 1, 2, 3, 5))
        temperature, top_p, min_p, pres, freq, rep = (float(first[i])
                                                      for i in (4, 6, 7, 8, 9, 10))
        logits = self._lm_logits(self.params, self.mcfg, hidden)      # [1, V]
        pen = logits
        if counting:
            pen = apply_penalties(
                logits, torch.zeros_like(logits, dtype=torch.int32),
                self.prompt_masks[slot][None], self._t([pres]), self._t([freq]),
                self._t([rep]),
            )
        # the prompt's last position: step 0, the grammar at its walked state
        pen = self._processors_and_grammar(
            pen, slice(slot, slot + 1), np.ones(1, bool), np.zeros(1, np.int64),
            np.array([seq_len]), np.array([g_state], np.int32))
        gumbel = None
        if temperature > 0.0:
            gumbel = gumbel_noise(
                [int(self._seeds[slot])], [0], self.mcfg.vocab_size, self.device
            )
        tok = sample_tokens(
            pen, self._t([temperature]), self._t([top_k]), self._t([top_p]),
            self._t([min_p]), gumbel, filtered=top_k > 0 or top_p < 1.0,
        )
        if counting:
            # the first generated token enters the output counts, or the
            # first decode step's penalties would miss it
            self.output_counts[slot, tok[0]] += 1
        lp = logprobs_of(logits, tok)
        tlp_ids = tlp_vals = None
        if self._lp_ns[slot] > 0:
            vals, ids = top_logprobs(logits)
            tlp_ids, tlp_vals = ids[0].tolist(), vals[0].tolist()
        self._note_sampled("eager", [int(tok[0])])
        return int(tok[0]), float(lp[0]), tlp_ids, tlp_vals

    def _lora_kw(self, ids) -> dict:
        """The forward's ``lora`` argument for adapter ids: an int (a prefill
        chunk), a [B] host array (a decode batch) or ``(head_len, head_id,
        rows)`` (the mixed step's packed buffer); {} on an engine without
        LoRA or when every id is 0 (the identity adds exact zeros)."""
        if self.lora is None:
            return {}
        if isinstance(ids, tuple):
            head_len, head_id, rows = ids
            if head_id == 0 and not rows.any():
                return {}
            ids = PackedAdapterIds(head_len, head_id, self._t(rows))
        elif isinstance(ids, np.ndarray):
            if not ids.any():
                return {}
            ids = self._t(ids)
        elif ids == 0:
            return {}
        return {"lora": make_lora_fn(self.lora.tables(), ids)}

    def _processors_and_grammar(self, pen: torch.Tensor, rows: slice, active: np.ndarray,
                                steps: np.ndarray, seq_lens: np.ndarray,
                                g_state: np.ndarray) -> torch.Tensor:
        """The processors, then the grammar mask, on the logits of the
        slots ``rows`` (every slot, or one prefill's) in an eager step. The
        host knows which processors some active row opted into, so only
        those run (each under its row mask), and the mask runs only when a
        row is guided: the reference's ``lax.cond(any(mask))``, decided here
        before the launch."""
        masks = self._lp_masks[rows] & active[:, None]
        use = [k for k in range(len(self._procs)) if masks[:, k].any()]
        if use:
            state = {"output_counts": self.output_counts[rows], "steps": self._t(steps),
                     "seq_lens": self._t(seq_lens)}
            pen = apply_processors([self._procs[k] for k in use], self._t(masks[:, use]),
                                   pen, state)
        g_act = self._g_active[rows] & active
        if g_act.any():
            pen = guided_mask(pen, self._t(g_act), self._t(g_state), self.g_class[rows],
                              self.g_trans[rows])
        return pen

    def _decode_dispatch_arrays(self, seqs: List[Optional[_Seq]]):
        """Per-slot host arrays of ONE decode step over ``seqs`` (shared by
        the split decode and the fused mixed step); refreshes self._tokens.
        Returns (positions, seq_lens, write_blocks, write_offsets, steps)."""
        bs = self.cfg.block_size
        B = self.cfg.max_batch_size
        positions = np.zeros(B, np.int64)
        seq_lens = np.zeros(B, np.int32)
        write_blocks = np.zeros(B, np.int64)
        write_offsets = np.zeros(B, np.int64)
        steps = np.zeros(B, np.int64)
        for i, st in enumerate(seqs):
            if st is None:
                continue
            L = len(st.seq)                    # includes the token being fed
            positions[i] = L - 1
            seq_lens[i] = L
            st.kv_written = L
            self._tokens[i] = st.last_token
            write_blocks[i] = st.block_ids[(L - 1) // bs]
            write_offsets[i] = (L - 1) % bs
            steps[i] = st.produced
        return positions, seq_lens, write_blocks, write_offsets, steps

    def _counting(self, seqs: List[Optional[_Seq]]) -> bool:
        return any(st is not None and st.counting for st in seqs)

    def _decode_epilogue(self, hidden: torch.Tensor, seq_lens: np.ndarray, steps: np.ndarray,
                         count_rows: bool, count_slots: bool):
        """Sample one token for every active row of a decode step (rows
        with ``seq_lens`` 0 are idle); ``count_rows``: a row of the step
        keeps output counts, ``count_slots``: a resident sequence does.
        Returns each row's (tokens, logprobs, top ids or None, top values
        or None) as lists; ``_accepted`` gives them to their sequences."""
        logits = self._lm_logits(self.params, self.mcfg, hidden)      # [B, V]
        active = seq_lens > 0
        pen = logits
        if count_rows:
            pen = apply_penalties(
                logits, self.output_counts, self.prompt_masks,
                self._t(self._pres), self._t(self._freqs), self._t(self._reps),
            )
        pen = self._processors_and_grammar(pen, slice(None), active, steps, seq_lens,
                                           self._g_state)
        sampled = active & (self._temps > 0.0)
        gumbel = None
        if sampled.any():
            gumbel = gumbel_noise(
                [int(x) for x in self._seeds], steps.tolist(),
                self.mcfg.vocab_size, self.device, rows=sampled.tolist(),
            )
        toks = sample_tokens(
            pen, self._t(self._temps), self._t(self._top_ks),
            self._t(self._top_ps), self._t(self._min_ps), gumbel,
            filtered=bool(np.any((self._top_ks > 0) | (self._top_ps < 1.0))),
        )
        if count_slots:
            update_counts(self.output_counts, toks, self._t(active))
        lps = logprobs_of(logits, toks)
        tlp_ids = tlp_vals = None
        if ((self._lp_ns > 0) & active).any():
            vals, ids = top_logprobs(logits)
            tlp_ids, tlp_vals = ids.tolist(), vals.tolist()
        toks_l = toks.tolist()
        self._note_sampled("eager", toks_l)
        return toks_l, lps.tolist(), tlp_ids, tlp_vals

    def _accepted(self, seqs: List[Optional[_Seq]], rows) -> List[Accepted]:
        """A decode step's sampled rows (``_decode_epilogue``) given to the
        sequences of its snapshot."""
        toks_l, lps_l, tlp_ids, tlp_vals = rows
        out: List[Accepted] = []
        for i, st in enumerate(seqs):
            if st is None:
                continue
            if self._lp_ns[i] > 0:
                out.append((st, toks_l[i], lps_l[i], tlp_ids[i], tlp_vals[i]))
            else:
                out.append((st, toks_l[i], lps_l[i], None, None))
        return out

    @torch.inference_mode()
    def _run_decode(self, seqs: List[Optional[_Seq]]) -> List[Accepted]:
        positions, seq_lens, write_blocks, write_offsets, steps = (
            self._decode_dispatch_arrays(seqs)
        )
        rows = self._op["decode"](
            self._tokens, positions, seq_lens, write_blocks, write_offsets, steps,
            self._block_tables, np.where(seq_lens > 0, self._lora_slots, 0),
            self._counting(seqs), self._counting(self._slots))
        self._draft_decode_rows(seqs, positions, seq_lens, write_blocks, write_offsets)
        return self._accepted(seqs, rows)

    @torch.inference_mode()
    def _dev_decode(self, tokens, positions, seq_lens, write_blocks, write_offsets, steps,
                    block_tables, lora_ids, count_rows: bool, count_slots: bool):
        """Device op of one eager decode step over every slot (rows with
        ``seq_lens`` 0 are idle): the fed ``tokens`` at ``positions``,
        their KV written at (``write_blocks``, ``write_offsets``), then
        ``_decode_epilogue``."""
        tables = self._t(block_tables)
        lens_t = self._t(seq_lens)
        wb, wo = self._t(write_blocks), self._t(write_offsets)
        # for layers with attention attributes: the decode batch as q_len = 1
        # rows of the unified kernel (inactive slots: q_len 0); its
        # max_seq_len also sizes the decode kernel's split grid
        unified = _UnifiedRows(self._t, np.arange(len(seq_lens)), seq_lens > 0, seq_lens)

        def attend(q, k_new, v_new, layer_idx, **extra):
            kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
            att.write_decode_kv(kc, vc, k_new[:, 0], v_new[:, 0], wb, wo)
            if extra or self._latent:
                return self._ragged(q[:, 0], kc, vc, tables, unified.rows(), 1,
                                    unified.max_seq_len, unified.attrs(**extra))[:, None]
            return cuda_attention.paged_decode_attention(
                q[:, 0], kc, vc, tables, lens_t, max_seq_len=unified.max_seq_len
            )[:, None]

        hidden = self._forward(
            self.params, self.mcfg, self._t(tokens)[:, None],
            self._t(positions)[:, None], attend, **self._lora_kw(np.asarray(lora_ids)),
        )                                                   # [B, 1, H]
        self.step_counts["decode"] += 1
        return self._decode_epilogue(hidden[:, 0], seq_lens, steps, count_rows, count_slots)

    def _draft_decode_rows(self, seqs: List[Optional[_Seq]], positions: np.ndarray,
                           seq_lens: np.ndarray, write_blocks: np.ndarray,
                           write_offsets: np.ndarray) -> None:
        """Spec decoding: a decode step outside a spec horizon (one eager
        step, a mixed step's decode rows) also writes the DRAFT's KV of the
        tokens it feeds (one draft forward, no logits), so that the shadow
        cache covers every position the main cache does. The reference
        leaves such positions stale in the draft cache, which costs
        acceptance only (ROADMAP.md Queue 3)."""
        if not any(st is not None and st.spec_ok for st in seqs):
            return
        tables, lens_t = self._t(self._block_tables), self._t(seq_lens)
        wb, wo = self._t(write_blocks), self._t(write_offsets)
        unified = _UnifiedRows(self._t, np.arange(len(seq_lens)), seq_lens > 0, seq_lens)

        def attend(q, k_new, v_new, layer_idx, **extra):
            kc, vc = self.draft_k_caches[layer_idx], self.draft_v_caches[layer_idx]
            att.write_decode_kv(kc, vc, k_new[:, 0], v_new[:, 0], wb, wo)
            if extra:
                return self._unified(q[:, 0], kc, vc, tables, unified.rows(), 1,
                                     unified.max_seq_len, unified.attrs(**extra))[:, None]
            return cuda_attention.paged_decode_attention(
                q[:, 0], kc, vc, tables, lens_t, max_seq_len=unified.max_seq_len)[:, None]

        self._draft_forward(self.draft_params, self.cfg.spec_draft,
                            self._t(self._tokens)[:, None], self._t(positions)[:, None],
                            attend)

    @torch.inference_mode()
    def _run_mixed_step(self, st: _Seq, seqs: List[Optional[_Seq]]):
        """ONE fused forward: st's next prefill chunk (row 0 of the unified
        launch) and one decode step for the ``seqs`` snapshot (rows 1..B).
        The packed token buffer is [S_pad + B]: the chunk's bucketed tokens,
        then one decode token per slot. Returns (decode acceptances, the
        chunk's first-token acceptance or None)."""
        start, chunk_len, is_final, (c_tokens, c_positions, c_new_ids), dev = (
            self._next_chunk(st))
        total_len = start + chunk_len
        positions, seq_lens, write_blocks, write_offsets, steps = (
            self._decode_dispatch_arrays(seqs)
        )
        chunk_table = np.zeros((1, self._block_tables.shape[1]), np.int32)
        chunk_table[0] = self._block_tables[st.slot]
        # the packed buffer concatenates the chunk's host arrays with the
        # decode rows'; a prebuilt chunk's page ids are on the device already
        rows, got = self._op["mixed"](
            np.concatenate([c_tokens, self._tokens]), np.concatenate([c_positions, positions]),
            dev[2] if dev is not None else c_new_ids,
            np.concatenate([chunk_table, self._block_tables]), start, chunk_len,
            write_blocks, write_offsets, seq_lens, steps, int(self._lora_slots[st.slot]),
            np.where(seq_lens > 0, self._lora_slots, 0), self._counting(seqs),
            self._counting(self._slots), self._first_args(st) if is_final else None)
        st.prefill_pos = total_len
        self._schedule_next_chunk(st, is_final)
        self._advance_draft_prefill(st)
        self._draft_decode_rows(seqs, positions, seq_lens, write_blocks, write_offsets)
        return self._accepted(seqs, rows), None if got is None else (st, *got)

    @torch.inference_mode()
    def _dev_mixed(self, tokens, positions, c_new_ids, tables, start: int, chunk_len: int,
                   write_blocks, write_offsets, seq_lens, steps, head_lora: int, row_loras,
                   count_rows: bool, count_slots: bool, first: Optional[np.ndarray]):
        """Device op of the fused mixed step: the packed ``tokens`` /
        ``positions`` [S_pad + B] (the chunk's padded rows, then one decode
        row per slot), the chunk's pages, the [1 + B] block ``tables``, the
        decode rows' writes; returns (``_decode_epilogue``'s rows, the
        first token's sampling when ``first`` is given, else None)."""
        B = self.cfg.max_batch_size
        S_pad = len(tokens) - B
        total_len = start + chunk_len
        tables = self._t(tables)
        unified = _UnifiedRows(self._t, np.concatenate([[0], S_pad + np.arange(B)]),
                               np.concatenate([[chunk_len], seq_lens > 0]),
                               np.concatenate([[total_len], seq_lens]))
        c_new_ids_t = self._dev(c_new_ids)
        wb, wo = self._t(write_blocks), self._t(write_offsets)

        pad = self._pad_rows(chunk_len, S_pad)

        def attend(q, k_new, v_new, layer_idx, **extra):
            # extra: the layer's attention attributes (gemma, gpt-oss), if any
            kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
            att.write_prefill_kv(kc, vc, *pad(k_new[:S_pad], v_new[:S_pad]), c_new_ids_t)
            att.write_decode_kv(kc, vc, k_new[S_pad:], v_new[S_pad:], wb, wo)
            return self._ragged(q, kc, vc, tables, unified.rows(), chunk_len,
                                unified.max_seq_len, unified.attrs(**extra))

        # the packed buffer's adapters as its segments: the chunk's rows
        # with its request's, then one decode row per slot
        lora = self._lora_kw((S_pad, head_lora, np.asarray(row_loras)))
        hidden = self._forward(self.params, self.mcfg, self._t(tokens), self._t(positions),
                               attend, **lora)
        self.step_counts["mixed"] += 1
        rows = self._decode_epilogue(hidden[S_pad:], seq_lens, steps, count_rows, count_slots)
        got = None
        if first is not None:
            got = self._first_token(hidden[chunk_len - 1:chunk_len], first)
        return rows, got

    # ------------------------------------------------ decode horizon
    def _dispatch_horizon(self, chain: Optional[_Chain],
                          seqs: List[Optional[_Seq]]) -> _Chain:
        """Step executor: stage the horizon's inputs and run it (one graph
        replay on CUDA) over the loop-thread ``seqs`` snapshot. With
        ``chain``, the carry (tokens, seq_lens, steps) is the one that
        horizon leaves in the static buffers; without, it is written from
        the host state. Every dispatch stages the block tables (booked
        pages) and the active rows. On a spec engine a dispatch whose rows
        are all spec-eligible runs the spec body instead; its advance is
        known only on the device, so ``lens_after`` is the bound ``lens +
        rounds * spec_k``."""
        hz, c = self._horizon, self.cfg
        hs = hz.state
        slot = hz.next_slot()
        active = np.array([st is not None for st in seqs])
        if chain is None:
            carry = hs.carry.host_views[slot]
            carry["tokens"][:] = 0
            carry["seq_lens"][:] = 0
            carry["steps"][:] = 0
            for i, st in enumerate(seqs):
                if st is not None:
                    carry["tokens"][i] = st.last_token
                    carry["seq_lens"][i] = len(st.seq)
                    carry["steps"][i] = st.produced
            if hs.guided:
                carry["g_state"][:] = np.where(active, self._g_state, 0)
            lens = carry["seq_lens"].copy()
        else:
            lens = chain.lens_after
        counting = any(o is not None and o.counting for o in self._slots)
        inp = hs.inputs.host_views[slot]
        inp["tables"][:] = self._block_tables
        inp["active"][:] = active
        inp["count_rows"][:] = active & counting
        inp["sample_rows"][:] = active & (self._temps > 0.0)
        inp["seeds"][:] = self._seeds
        for name, arr in (("temps", self._temps), ("top_ks", self._top_ks),
                          ("top_ps", self._top_ps), ("min_ps", self._min_ps),
                          ("pres", self._pres), ("freqs", self._freqs),
                          ("reps", self._reps)):
            inp[name][:] = arr
        if hs.guided:
            inp["g_active"][:] = active & self._g_active
        if hs.lora:
            inp["lora_ids"][:] = np.where(active, self._lora_slots, 0)
        if hs.processors:
            inp["proc_masks"][:] = self._lp_masks & active[:, None]
        # a fresh carry goes as its host bytes, a chained one stays on the
        # device (each rank's own)
        carry = hs.carry.host[slot].numpy() if chain is None else hs.carry.dev
        inputs = hs.inputs.host[slot].numpy()
        if self._spec and self._spec_eligible(seqs):
            adv = self._spec_rounds * c.spec_k
            # bounds the verify rows' lengths in the last round
            host, event, _ = self._op["horizon"](slot, carry, inputs,
                                                 int(lens[active].max()) + adv, False, True,
                                                 False)
            return _Chain(seqs=list(seqs), host=host, event=event,
                          lens_after=lens + adv * active.astype(np.int32),
                          fetch=self._submit_fetch(host, event), spec=True)
        n = c.decode_steps
        max_seq_len = int(lens[active].max()) + n - 1
        host, event, _ = self._op["horizon"](slot, carry, inputs, max_seq_len,
                                             bool(inp["sample_rows"].any()), False,
                                             bool(hs.features and self._feature_rows(seqs)))
        return _Chain(seqs=list(seqs), host=host, event=event,
                      lens_after=lens + n * active.astype(np.int32),
                      fetch=self._submit_fetch(host, event))

    def _dev_horizon(self, slot: int, carry, inputs: np.ndarray, max_seq_len: int,
                     sampled: bool, spec: bool, feat: bool):
        """Device op of one horizon in ring slot ``slot``: the carry's host
        bytes (a fresh carry) or the device carry (a chained horizon, which
        each rank keeps), the inputs' host bytes, then the horizon (the
        spec body with ``spec``, the feature body with ``feat``). Returns
        (the packed results' host copy, its event, the device carry). A
        follower waits for its run before the next op."""
        hz = self._horizon
        hs = hz.state
        if isinstance(carry, np.ndarray):
            # (on the leader these are the bytes already in its host slot)
            np.copyto(hs.carry.host[slot].numpy(), carry)
            hs.carry.upload(slot)
        np.copyto(hs.inputs.host[slot].numpy(), inputs)
        hs.inputs.upload(slot)
        host, event = hz.run(slot, max_seq_len, sampled, spec=spec, feat=feat)
        self.step_counts["spec" if spec else "horizon"] += 1
        if not self.is_leader:
            if event is not None:
                event.synchronize()
            self._note_sampled("horizon", host.numpy()[:, :, 0])
        return host, event, hs.carry.dev

    @torch.inference_mode()
    def _decode_multi(self, hs: HorizonState, max_seq_len: int, sampled: bool,
                      feat: bool = False) -> None:
        """The horizon body: ``decode_steps`` decode iterations on device
        tensors only (no readback, no host-to-device copy: it is what the
        CUDA graphs capture). Each step takes its positions from the carry
        ``seq_lens``, its write pages from the block tables (inactive rows
        write scratch block 0), writes the fed tokens' KV, attends (the
        decode kernel, or the q_len = 1 rows of the unified kernel for
        layers with attention attributes, of the latent kernel for MLA),
        applies the penalties (exact no-ops at their defaults), samples at
        ``steps + s``, updates the output counts
        and writes its row of ``hs.packed``; its samples are the next step's
        tokens. The carry is written back in place. ``max_seq_len``, a
        bound on every row's length in the horizon, sizes the split grids;
        ``sampled``: whether any row samples (else no Gumbel draw).
        ``feat``: the feature body, for a dispatch with a row that uses a
        per-request feature: every row's adapter delta (slot 0 adds zeros),
        every processor under its row mask after the penalties, and the
        grammar mask of the guided rows, whose FSM states advance by the
        sampled tokens and are written back to the carry."""
        n = hs.packed.shape[0]
        V = self.mcfg.vocab_size
        active = hs.active
        act = active.to(torch.int32)
        tokens, seq_lens = hs.tokens, hs.seq_lens
        lora, g_st = {}, None
        if feat:
            if hs.lora:
                # each slot's tables gathered once for the whole horizon
                lora = {"lora": make_lora_fn(self.lora.tables(), hs.lora_ids)}
            if hs.guided:
                g_st = hs.g_state
        for s in range(n):
            positions = torch.clamp(seq_lens - 1, min=0)
            wb, wo = self._write_pages(hs, positions)

            def attend(q, k_new, v_new, layer_idx, **extra):
                kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
                att.write_decode_kv(kc, vc, k_new[:, 0], v_new[:, 0], wb, wo)
                if extra or self._latent:
                    return self._ragged(q[:, 0], kc, vc, hs.tables,
                                        (hs.q_starts, act, seq_lens), 1, max_seq_len,
                                        hs.attrs(**extra))[:, None]
                return cuda_attention.paged_decode_attention(
                    q[:, 0], kc, vc, hs.tables, seq_lens, max_seq_len=max_seq_len)[:, None]

            hidden = self._forward(self.params, self.mcfg, tokens[:, None],
                                   positions[:, None], attend, **lora)
            logits = self._lm_logits(self.params, self.mcfg, hidden[:, 0])
            pen = apply_penalties(logits, self.output_counts, self.prompt_masks,
                                  hs.pres, hs.freqs, hs.reps)
            if feat and hs.processors:
                pen = apply_processors(self._procs, hs.proc_masks, pen, {
                    "output_counts": self.output_counts, "steps": hs.steps + s,
                    "seq_lens": seq_lens})
            if g_st is not None:
                pen = guided_mask(pen, hs.g_active, g_st, self.g_class, self.g_trans)
            gumbel = None
            if sampled:
                gumbel = gumbel_noise_tensor(hs.seeds, hs.steps + s, V, rows=hs.sample_rows)
            toks = sample_tokens(pen, hs.temps, hs.top_ks, hs.top_ps, hs.min_ps, gumbel)
            if g_st is not None:
                g_st = guided_step(g_st, toks, hs.g_active, self.g_class, self.g_trans)
            update_counts(self.output_counts, toks, hs.count_rows)
            vals, ids = top_logprobs(logits)
            hs.packed[s].copy_(torch.cat(
                [toks[:, None].float(), logprobs_of(logits, toks)[:, None], ids.float(), vals],
                dim=1))
            tokens = toks
            seq_lens = seq_lens + act
        hs.tokens.copy_(tokens)
        hs.seq_lens.copy_(seq_lens)
        hs.steps.add_(act * n)
        if g_st is not None:
            hs.g_state.copy_(g_st)

    def _spec_eligible(self, seqs: List[Optional[_Seq]]) -> bool:
        """Every active row greedy, with no penalties, no logprobs, no
        processors and no grammar (the verify's argmax is sample_tokens at
        temperature 0; the spec packed format carries token logprobs only;
        the spec body carries neither processors nor the grammar mask, as
        the reference's). Otherwise the whole dispatch runs the normal
        horizon."""
        for i, st in enumerate(seqs):
            if st is not None and (
                    self._temps[i] != 0.0 or self._lp_ns[i] != 0 or self._pres[i] != 0.0
                    or self._freqs[i] != 0.0 or self._reps[i] != 1.0
                    or self._lp_masks[i].any() or self._g_active[i]):
                return False
        return True

    @torch.inference_mode()
    def _spec_multi(self, hs: HorizonState, max_seq_len: int) -> None:
        """The spec horizon body: ``R`` rounds on device tensors only (what
        the CUDA graphs capture). Each round: ``k`` greedy draft steps
        through the decode kernel over the shadow cache (step j feeds the
        last token at position ``seq_lens - 1 + j``); the ``k + 1``
        candidates' KV written into the main cache; ONE main forward whose
        attention is the unified kernel over ``q_len = k + 1`` rows
        (``cuda_unified.verify_attention``); then the accept: ``n_acc`` =
        the matched prefix of the drafts against the verify's argmax ``m``,
        an advance ``adv = min(n_acc + 1, k)`` (the cap keeps the last
        candidate's logits and KV irrelevant and every round's advance
        within the draft's writes), the carry token ``m[adv - 1]``. Writes
        ``hs.spec_packed[r]`` = [adv, m[:k], the greedy tokens' logprobs]
        and moves the carry (tokens, seq_lens, steps) in place as
        ``_decode_multi`` does, so spec and normal horizons chain.
        ``max_seq_len`` bounds every row's length in the horizon."""
        tokens, seq_lens = hs.tokens, hs.seq_lens
        emitted = torch.zeros_like(hs.steps)
        for r in range(hs.spec_packed.shape[0]):
            drafts = self._spec_draft(hs, tokens, seq_lens, max_seq_len)
            tokens, adv = self._spec_verify(hs, tokens, seq_lens, drafts, max_seq_len, r)
            seq_lens = seq_lens + adv.to(seq_lens.dtype)
            emitted = emitted + adv
        hs.tokens.copy_(tokens)
        hs.seq_lens.copy_(seq_lens)
        hs.steps.add_(emitted)

    def _write_pages(self, hs: HorizonState, pos: torch.Tensor):
        """Write page and offset of each row's position ``pos`` [B] from the
        block tables; inactive rows write scratch block 0."""
        bs = self.cfg.block_size
        blk = torch.gather(hs.tables, 1, (pos // bs).long()[:, None])[:, 0]
        return torch.where(hs.active, blk, 0), torch.where(hs.active, pos % bs, 0)

    def _spec_draft(self, hs: HorizonState, tokens: torch.Tensor, seq_lens: torch.Tensor,
                    max_seq_len: int) -> torch.Tensor:
        """A round's k greedy draft steps over the shadow cache: step j
        feeds its token at position ``seq_lens - 1 + j`` through the decode
        kernel, or, for a draft whose layers pass attention attributes
        (Gemma), as the q_len = 1 rows of the unified kernel with them (as
        the reference keeps windowed drafts off its split decode kernel).
        Returns the drafts [B, k]."""
        dcfg = self.cfg.spec_draft
        act = hs.active.to(torch.int32)
        start = torch.clamp(seq_lens - 1, min=0).long()
        fed, drafts = tokens, []
        for j in range(self.cfg.spec_k):
            wb, wo = self._write_pages(hs, start + j)
            lens_j = seq_lens + j * act

            def attend(q, k_new, v_new, layer_idx, **extra):
                kc, vc = self.draft_k_caches[layer_idx], self.draft_v_caches[layer_idx]
                att.write_decode_kv(kc, vc, k_new[:, 0], v_new[:, 0], wb, wo)
                if extra:
                    return self._unified(q[:, 0], kc, vc, hs.tables,
                                         (hs.q_starts, act, lens_j), 1, max_seq_len,
                                         hs.attrs(**extra))[:, None]
                return cuda_attention.paged_decode_attention(
                    q[:, 0], kc, vc, hs.tables, lens_j, max_seq_len=max_seq_len)[:, None]

            hidden = self._draft_forward(self.draft_params, dcfg, fed[:, None],
                                         (start + j)[:, None], attend)
            fed = torch.argmax(self._draft_logits(self.draft_params, dcfg, hidden[:, 0]), dim=-1)
            drafts.append(fed)
        return torch.stack(drafts, dim=1)

    def _spec_verify(self, hs: HorizonState, tokens: torch.Tensor, seq_lens: torch.Tensor,
                     drafts: torch.Tensor, max_seq_len: int, r: int):
        """A round's verify and accept: the k + 1 candidates' main KV
        written, one main forward over them as ``q_len = k + 1`` rows of the
        family's ragged kernel (the unified kernel with each layer's
        window, softcap and sinks; the latent kernel for MLA), ``adv =
        min(n_acc + 1, k)``, the carry token ``m[adv - 1]``; writes
        ``hs.spec_packed[r]``. Returns (carry tokens, adv)."""
        k, B, active = self.cfg.spec_k, tokens.shape[0], hs.active
        start = torch.clamp(seq_lens - 1, min=0).long()
        cand = torch.cat([tokens[:, None], drafts], dim=1)              # [B, k+1]
        pos = start[:, None] + hs.spec_offsets[None, :]
        writes = [self._write_pages(hs, pos[:, s]) for s in range(k + 1)]
        total = seq_lens + k

        def attend(q, k_new, v_new, layer_idx, **extra):
            kc, vc = self.k_caches[layer_idx], self.v_caches[layer_idx]
            for s, (wb, wo) in enumerate(writes):
                att.write_decode_kv(kc, vc, k_new[:, s], v_new[:, s], wb, wo)
            if self._latent:
                return cuda_mla.latent_verify_attention(
                    q, kc, hs.tables, total, active, v_dim=self.mcfg.kv_lora_rank,
                    max_seq_len=max_seq_len)
            return cuda_unified.verify_attention(q, kc, vc, hs.tables, total, active,
                                                 max_seq_len=max_seq_len, **extra)

        hidden = self._forward(self.params, self.mcfg, cand, pos, attend)    # [B, k+1, H]
        logits = self._lm_logits(self.params, self.mcfg,
                                 hidden.reshape(B * (k + 1), -1)).reshape(B, k + 1, -1)
        m = torch.argmax(logits, dim=-1)
        lps = torch.log_softmax(logits, dim=-1).max(dim=-1).values
        n_acc = torch.cumprod((m[:, :k] == drafts).to(torch.int32), dim=1).sum(dim=1)
        adv = torch.where(active, torch.clamp(n_acc + 1, max=k), 0)
        carry = torch.where(
            active, torch.gather(m, 1, torch.clamp(adv - 1, min=0)[:, None])[:, 0], tokens)
        hs.spec_packed[r].copy_(torch.cat([adv[:, None].float(), m[:, :k].float(),
                                           lps[:, :k]], dim=1))
        return carry, adv

    def _submit_fetch(self, host: torch.Tensor, event):
        """The fetch thread's future of a horizon's packed results, taken
        in dispatch order; their tokens are noted for ``sampled_digest``."""
        def fetch() -> np.ndarray:
            packed = HorizonGraphs.fetch(host, event)
            self._note_sampled("horizon", packed[:, :, 0])
            return packed

        self._last_fetch = self._fetch_executor.submit(fetch)
        return self._last_fetch

    def _note_sampled(self, kind: str, tokens) -> None:
        digest = self._sampled[kind]
        digest[0].update(np.asarray(tokens, np.int64).tobytes())
        digest[1] += 1

    def sampled_digest(self) -> Dict[str, Dict[str, Any]]:
        """By kind ("eager": first tokens and eager decode steps in op
        order; "horizon": column 0 of every horizon's packed results, its
        [N, B] tokens, in dispatch order, idle rows too), the number of
        sampling results and the SHA-256 of their tokens: a follower's
        equal its leader's when it sampled what the leader did."""
        if self._last_fetch is not None:
            self._last_fetch.result()   # the fetch thread takes them in order
        return {kind: {"n": n, "sha256": h.hexdigest()}
                for kind, (h, n) in self._sampled.items()}

    def _apply_packed(self, chain: _Chain, packed: np.ndarray) -> None:
        """Apply one fetched horizon [N, B, 2+2K]: each snapshot sequence's
        tokens go through stop handling in order (the tail after a finish
        is discarded) and leave as ONE BackendOutput. The horizon wrote
        the KV of every token it fed: all but its last sample's."""
        if chain.spec:
            return self._apply_packed_spec(chain, packed)
        K = TOP_LOGPROBS_K
        n = packed.shape[0]
        toks = packed[:, :, 0].astype(np.int64)
        lps = packed[:, :, 1]
        tlp_ids = packed[:, :, 2:2 + K].astype(np.int64)
        tlp_vals = packed[:, :, 2 + K:]
        for i, st in enumerate(chain.seqs):
            if st is None or st.done:
                continue
            L = len(st.seq)
            want = st.req.sampling.logprobs > 0
            self._accept_tokens(st, toks[:, i].tolist(), lps[:, i].tolist(),
                                tlp_ids[:, i] if want else None,
                                tlp_vals[:, i] if want else None)
            st.kv_written = max(st.kv_written, min(len(st.seq), L + n - 1))

    def _apply_packed_spec(self, chain: _Chain, packed: np.ndarray) -> None:
        """Apply one fetched spec horizon [R, B, 1+2k]: round r gave row i
        ``adv`` tokens (column 0, 1..k); they go through the same stop
        handling as a horizon's. The rounds wrote the main KV of every
        accepted token but the carry."""
        k = self.cfg.spec_k
        for i, st in enumerate(chain.seqs):
            if st is None or st.done:
                continue
            toks: List[int] = []
            lps: List[float] = []
            for row in packed[:, i]:
                adv = int(row[0])
                toks += row[1:1 + adv].astype(np.int64).tolist()
                lps += row[1 + k:1 + k + adv].tolist()
            self.spec_stats["rounds"] += packed.shape[0]
            self.spec_stats["emitted"] += len(toks)
            L = len(st.seq)
            self._accept_tokens(st, toks, lps)
            st.kv_written = max(st.kv_written, min(len(st.seq), L + len(toks) - 1))

    def snapshot(self) -> Dict[str, Any]:
        """Host counters of the engine's state (the status server's
        /metadata and /debug/worker read it; no device sync)."""
        snap: Dict[str, Any] = {
            "running": sum(1 for s in self._slots if s is not None),
            "waiting": len(self._waiting),
            "active_blocks": self.allocator.active_blocks,
            "cached_blocks": self.allocator.cached_blocks,
            "free_blocks": self.allocator.free_blocks,
            "steps": dict(self.step_counts),
        }
        if self._spec:
            snap["spec"] = dict(self.spec_stats)
        if self.kvbm is not None:
            snap["kvbm"] = self.kvbm.stats()
        return snap

    async def clear_kv_blocks(self, levels: Optional[List[str]] = None) -> Dict[str, Any]:
        """Runtime cache reset (the reference's ``clear_kv_blocks``): drop
        the device prefix cache (g1) and/or the KVBM tiers (g2 host, g3
        disk). Requests in flight keep their pinned blocks; only reusable
        cache is dropped. A g1 clear publishes a wholesale CLEARED event for
        this worker; tier clears ride the consolidated removed-event path.
        ``None`` clears every level, an empty list none."""
        if levels is not None and (
            not isinstance(levels, (list, tuple))
            or any(not isinstance(lv, str) for lv in levels)
        ):
            raise ValueError("levels must be a list of tier names")
        levels = [lv.lower() for lv in (levels if levels is not None else ["g1", "g2", "g3"])]
        result: Dict[str, Any] = {}
        if "g1" in levels:
            before = self.allocator.cached_blocks
            self.allocator.clear()
            if self.kv_publisher is not None:
                await self.kv_publisher.cleared()
            result["g1"] = before
        if self.kvbm is not None and ("g2" in levels or "g3" in levels):
            counts = self.kvbm.clear(host="g2" in levels, disk="g3" in levels)
            result.update({k: v for k, v in counts.items() if k in levels})
            # the eviction notifications go out now, not at the next tick
            await self._publish_events()
        result["snapshot"] = self.snapshot()
        return result

    def spec_acceptance(self) -> Optional[float]:
        """emitted / (rounds * k): the share of drafted tokens the device
        advanced (1.0 for a perfect draft); None before any spec round."""
        st = self.spec_stats
        return st["emitted"] / (st["rounds"] * st["k"]) if st["rounds"] else None

    # ------------------------------------------------- KVBM offload/onboard
    async def _offload_ready_blocks(self) -> None:
        """Loop thread, at the end of a tick: gather every block whose KV is
        written and that awaits offload. The gathers go through the step
        executor, so they are enqueued on the device in order before any
        later step could evict and rewrite those pages; only the copy to
        the host runs on the offload thread."""
        if not self._offload_pending:
            return
        pending, self._offload_pending = self._offload_pending, []
        loop = asyncio.get_running_loop()
        gathered, ready = await loop.run_in_executor(
            self._executor, self._enqueue_offload_gather, pending
        )
        self._offload_executor.submit(self._offload_fetch, pending, gathered, ready)

    async def flush_offload(self, timeout_s: float = 30.0) -> None:
        """With KVBM: wait until the step loop is idle and every block it
        offloaded has reached the tiers (tests, benchmarks, shutdown)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while self._loop_task is not None and not self._loop_task.done() and (
                not self._idle) and loop.time() < deadline:
            await asyncio.sleep(0.005)
        done = self._offload_executor.submit(lambda: None)
        await loop.run_in_executor(None, done.result, timeout_s)
        await loop.run_in_executor(None, self.kvbm.flush, timeout_s)

    @torch.inference_mode()
    def _enqueue_offload_gather(self, pending: List[Tuple[int, int, int]]):
        """Step executor: launch ONE page gather of the pending blocks, every
        layer's K and V (and scale rows) at once, into a fresh buffer in the
        host storage layout [n, L, 2, ...] (block_copy.gather_layers), on the
        step's stream; returns (the buffer, or for an int8 cache a
        (payload, scales) QuantizedKV, and an event recorded after it, or
        None on the CPU)."""
        ids = self._t([bid for bid, _, _ in pending], torch.int32)
        gathered = bc.gather_layers(self.k_caches, self.v_caches, ids)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record()
        return gathered, ready

    def _offload_fetch(self, pending, gathered, ready) -> None:
        """Offload thread: wait for the gather (on a side stream, so the
        copy overlaps later steps), copy its buffer to fresh host memory and
        hand each block to the KVBM priority queue. The tier bytes are the
        storage format (kvbm/layout): the int8 codec buffer, or model-dtype
        pages (bf16 as bit patterns)."""
        try:
            with torch.inference_mode(), torch.cuda.stream(self._offload_stream):
                if ready is not None:
                    self._offload_stream.wait_event(ready)
                blocks = self._storage_blocks(gathered, len(pending))
            for (_, h, prio), block in zip(pending, blocks):
                self.kvbm.offload(h, block, priority=prio)
        except Exception:
            self.offload_errors += 1
            log.exception("kv offload of %d blocks failed", len(pending))

    def _storage_blocks(self, gathered, n: int) -> List[np.ndarray]:
        """A gather_layers buffer of ``n`` blocks copied to the host, one
        array a block in the storage format (kvbm/layout): the int8 codec
        buffer, or model-dtype pages (bf16 as bit patterns). The bytes of
        a KVBM tier block and of a checkpoint's block file."""
        if self.kv_quantized:
            pay = gathered.data.cpu().numpy()
            scl = gathered.scale.cpu().numpy()
            return [self._codec.encode(pay[i], scl[i]) for i in range(n)]
        arr = to_host(gathered.cpu())
        return [arr[i].copy() for i in range(n)]

    def _device_pages(self, a) -> torch.Tensor:
        """A host storage array or a tensor, on this engine's device. A
        wire frame's array is read-only (numpy over the frame's bytes): the
        tensor over it is only read, by the upload or the scatter."""
        if isinstance(a, np.ndarray):
            if not a.flags.writeable:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", UserWarning)
                    return from_host(a).to(self.device)
            return from_host(a).to(self.device)
        return a.to(self.device)

    def _cache_pages(self, parts: List[torch.Tensor]):
        """Transferred pages in this cache's format: as they are when the
        formats match; int8 pages at a float cache dequantize, float pages
        at an int8 cache quantize (ops/quant, as the reference's import),
        and a float of another dtype casts."""
        if self.kv_quantized:
            if len(parts) == 2:
                return QuantizedKV(*parts)
            from ..ops.quant import quantize_blocks

            return QuantizedKV(*quantize_blocks(parts[0].float()))
        if len(parts) == 2:
            from ..ops.quant import dequantize_blocks

            return dequantize_blocks(*parts).to(self.mcfg.dtype)
        return parts[0].to(self.mcfg.dtype)

    @torch.inference_mode()
    def _scatter_blocks(self, local_ids: List[int], arr, wire: bool = False, after=None):
        """Step executor: upload the blocks and scatter them into device
        pages with ONE launch (no allocator access here: the allocator lives
        on the loop thread); returns an event recorded after the scatter on
        the card, else None.

        ``arr`` is model-dtype pages [n, L, 2, bs, kvh, d] (host storage
        form, kvbm/layout) or, for an int8 cache, a (payload int8 [n, L, 2,
        bs, kvh, d], scales f32 [n, L, 2, kvh]) pair that scatters straight
        into the quantized cache, bit-exactly (block_copy.scatter_layers).
        With ``wire`` the pages are in the transfer wire's layer-major
        layout [L, 2, n, ...] (scales [L, 2, n, kvh]), host arrays or
        tensors on the card (block_copy.scatter_layers_wire); ``after``,
        an event of another thread's stream, is waited for first."""
        ids = self._t(local_ids, torch.int32)
        if after is not None:
            torch.cuda.current_stream(self.device).wait_event(after)
        parts = ([arr.data, arr.scale] if isinstance(arr, QuantizedKV)
                 else list(arr) if isinstance(arr, tuple) else [arr])
        pages = self._cache_pages([self._device_pages(a) for a in parts])
        (bc.scatter_layers_wire if wire else bc.scatter_layers)(
            self.k_caches, self.v_caches, ids, pages)
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    async def import_blocks(self, hashes: List[int], arr, wire: bool = False,
                            sync: bool = False, after=None) -> int:
        """Import pages as content-addressed cached pages; returns the
        number imported (0 when the pool has no room). ``arr``: [n, L, 2,
        bs, kvh, d] pages (or an int8 (payload, scales) pair, see
        _scatter_blocks), or with ``wire`` the transfer wire's [L, 2, n,
        ...] layout. ``sync`` returns only once the scatter has run on the
        card (the device path frees the source's staging slots after it).
        Allocator changes stay on the loop thread; only the scatter runs on
        the executor. The commits publish stored KV events with the next
        tick's events and wake streamed fetches of this engine's pages."""
        self._refuse_at_tp("importing KV pages (transfer, checkpoint restore)")
        first = arr[0] if isinstance(arr, tuple) else (
            arr.data if isinstance(arr, QuantizedKV) else arr)
        n = first.shape[2] if wire else first.shape[0]
        try:
            local_ids = self.allocator.allocate(n)
        except OutOfBlocks:
            log.warning("no room to import %d blocks; skipping", n)
            return 0
        loop = asyncio.get_running_loop()
        try:
            ev = await loop.run_in_executor(self._executor, self._scatter_blocks, local_ids,
                                            arr, wire, after)
            if sync and ev is not None:
                await loop.run_in_executor(None, ev.synchronize)
        except BaseException:
            self.allocator.release(local_ids)
            raise
        for bid, h in zip(local_ids, hashes):
            self.allocator.commit(bid, h)
        self.allocator.release(local_ids)
        if n and self.kv_commits is not None:
            self.kv_commits.fire()
        return n

    async def _onboard_from_kvbm(self, st: _Seq) -> None:
        """Pull a host/disk-cached prefix into device pages before
        admission (blocks strictly before the last prompt token, as
        admission reuses)."""
        bs = self.cfg.block_size
        hashes = st.seq.sequence_hashes()[: (len(st.seq) - 1) // bs]
        have = len(self.allocator.match_prefix(hashes))
        loop = asyncio.get_running_loop()
        n = await loop.run_in_executor(None, self.kvbm.match_prefix, hashes[have:])
        if n == 0:
            return
        want = hashes[have:have + n]
        arr = await loop.run_in_executor(None, self.kvbm.load_prefix, want)
        if arr is None:
            return
        # format guard: the disk tier survives restarts, so blocks written
        # under another kv_dtype or model shape can come back under the same
        # content hashes; they are a miss, never imported
        if self.kv_quantized:
            if arr.dtype != np.uint8 or arr.ndim != 2 or arr.shape[1] != self._codec.nbytes:
                log.warning("kvbm blocks are not this engine's int8 codec format "
                            "(%s %s); skipping onboard", arr.dtype, arr.shape)
                return
            arr = self._codec.decode_many(arr)
        else:
            m = self.mcfg
            expect = (m.num_layers, 2, self.cfg.block_size, m.num_kv_heads, m.head_dim)
            if arr.ndim != 6 or arr.shape[1:] != expect or arr.dtype != storage_dtype(m.dtype):
                log.warning("kvbm blocks do not match this engine's KV layout "
                            "(%s %s vs %s); skipping onboard", arr.dtype,
                            arr.shape[1:], expect)
                return
        got = await self.import_blocks(list(want), arr)
        if got:
            log.debug("onboarded %d blocks from kvbm for %s", got, st.req.request_id[:8])

    # ------------------------------------------------ host-side bookkeeping
    def _accept_token(self, st: _Seq, tok: int, logprob: float,
                      tlp_ids: Optional[List[int]] = None,
                      tlp_vals: Optional[List[float]] = None) -> None:
        """Apply one sampled token (a prefill's, a decode step's)."""
        self._accept_tokens(st, [tok], [logprob],
                            None if tlp_ids is None else [tlp_ids],
                            None if tlp_vals is None else [tlp_vals])

    def _accept_tokens(self, st: _Seq, toks: List[int], logprobs: List[float],
                       tlp_ids=None, tlp_vals=None) -> None:
        """Apply a run of sampled tokens (a horizon's, or one) to their
        sequence in order and stream what survives, or the finish, as ONE
        BackendOutput; the tokens after a finish are the discarded
        speculative tail. ``tlp_ids`` / ``tlp_vals``: [n, K] top logprobs."""
        if st.done:
            return
        first = st.produced == 0
        stop = st.req.stop
        n_tlp = min(st.req.sampling.logprobs, TOP_LOGPROBS_K)
        tlp = [] if n_tlp > 0 and tlp_ids is not None else None
        emit: List[int] = []
        emit_lps: List[float] = []
        finish: Optional[str] = None
        for n, tok in enumerate(toks):
            st.produced += 1
            if tok in stop.stop_token_ids and st.produced > stop.min_tokens:
                finish = FINISH_STOP   # the stop token is not emitted
                break
            emit.append(tok)
            emit_lps.append(logprobs[n])
            if tlp is not None:
                tlp.append({int(i): float(v)
                            for i, v in zip(tlp_ids[n][:n_tlp], tlp_vals[n][:n_tlp])})
            if stop.max_tokens is not None and st.produced >= stop.max_tokens:
                finish = FINISH_LENGTH
            elif st.context.is_stopped():
                finish = FINISH_CANCELLED
            elif len(st.seq) + 1 >= self.cfg.max_context:
                finish = FINISH_LENGTH
            else:
                L_before = len(st.seq)
                sealed = st.seq.append(tok)
                st.last_token = tok
                if sealed is not None and not st.no_cache:
                    # its last row (this token) is written by a later step:
                    # it enters the prefix cache, and the offload queue,
                    # once that step ran (_commit_written_blocks)
                    self._sealed_unwritten.append((
                        st, sealed.position, st.block_ids[sealed.position],
                        sealed.sequence_hash,
                    ))
                # a block must exist for the NEXT token's write position
                if (L_before + 1) // self.cfg.block_size + 1 > len(st.block_ids):
                    try:
                        (new_id,) = self.allocator.allocate(1)
                    except OutOfBlocks:
                        finish = FINISH_LENGTH   # out of KV memory: end gracefully
                    else:
                        st.block_ids.append(new_id)
                        self._block_tables[st.slot, len(st.block_ids) - 1] = new_id
            if finish is not None:
                break
        if st.guided_tables is not None and emit:
            # the host walk of the FSM over the tokens that survived stop
            # handling: the state the next unchained dispatch starts from.
            # A sampled token is legal under the mask, so a refused step
            # means corrupted tables: the request fails, not the loop
            try:
                st.guided_state = st.guided_tables.walk(st.guided_state, emit)
                self._g_state[st.slot] = st.guided_state
            except ValueError:
                log.exception("guided FSM desync")
                finish = FINISH_ERROR
        ann: Dict[str, Any] = {}
        if first:
            ann = {"cached_tokens": st.cached_tokens,
                   "input_tokens": len(st.req.token_ids)}
            if st.t_first_token == 0:
                st.t_first_token = time.time_ns()
                get_flight_recorder().record(st.req.request_id, "first_token",
                                             slot=st.slot)
        st.out_queue.put_nowait(BackendOutput(
            token_ids=emit, finish_reason=finish, cumulative_tokens=st.produced,
            logprobs=emit_lps if emit else None, top_logprobs=tlp if tlp else None,
            annotations=ann,
        ))
        if finish is not None:
            st.done = True

    def _commit_written_blocks(self) -> None:
        """Content-address the decode-sealed blocks whose last row a step
        has written (and queue them for offload). Until then the device
        prefix cache must not serve them: a prefill that matched one would
        attend over an unwritten row. (The reference commits at sealing.)
        A sequence that finished before the write drops its entries."""
        bs = self.cfg.block_size
        waiting = []
        for entry in self._sealed_unwritten:
            st, idx, bid, h = entry
            if st.kv_written >= (idx + 1) * bs:
                self.allocator.commit(bid, h)
                if self.kvbm is not None:
                    self._offload_pending.append((bid, h, 1))
            elif not st.done:
                waiting.append(entry)
        self._sealed_unwritten = waiting

    def _request_finished(self, st: _Seq, finish_reason: str) -> None:
        """Close the request's flight-recorder timeline, feed the SLO
        ledger and the attribution aggregates, and emit its engine-phase
        spans (queue / prefill / decode, parented on the traceparent
        annotation). Host-side bookkeeping only."""
        flight = get_flight_recorder()
        rid = st.req.request_id
        failed = finish_reason == FINISH_ERROR
        if st.sla is not None:
            self._slo_finished(st, finish_reason)
        flight.finish(
            rid, error="engine error finish" if failed else None,
            error_class="engine_error" if failed else None,
            finish_reason=finish_reason, tokens=st.produced,
            **({"sla_class": st.sla.sla_class} if st.sla is not None else {}),
        )
        # the closed timeline into the worker's rolling per-(model, class)
        # phase aggregates: /debug/worker's "where does p99 go"
        try:
            timeline = flight.timeline(rid)
            if timeline is not None:
                get_attribution().observe_flight(
                    st.req.model,
                    st.sla.sla_class if st.sla is not None else "unclassified", timeline)
        except Exception:
            log.exception("attribution observe failed for %s", rid[:8])
        tracer = get_tracer()
        if not tracer.enabled:
            return
        tp = (st.req.annotations or {}).get("traceparent")
        if st.t_queued and st.t_admitted:
            tracer.emit("engine.queue", st.t_queued, st.t_admitted, traceparent=tp,
                        request_id=rid)
        prefill_start = st.t_prefill_start or st.t_admitted
        if prefill_start and st.t_first_token:
            tracer.emit("engine.prefill", prefill_start, st.t_first_token, traceparent=tp,
                        request_id=rid, prompt_tokens=len(st.req.token_ids),
                        cached_tokens=st.cached_tokens)
        if st.t_first_token:
            tracer.emit("engine.decode", st.t_first_token, time.time_ns(), traceparent=tp,
                        request_id=rid, status="ERROR" if failed else "OK",
                        tokens=st.produced, finish=finish_reason)

    def _slo_finished(self, st: _Seq, finish_reason: str) -> None:
        """Feed the worker's SLO ledger from the milestones: TTFT from the
        frontend's receipt stamp on the sla annotation when present (one
        host's wall clock), else from queue entry; ITL the request's mean
        decode gap."""
        spec = st.sla
        now_ns = time.time_ns()
        t0 = sla_t0_ns(st.req.annotations) or st.t_queued
        ttft_s = (st.t_first_token - t0) / 1e9 if st.t_first_token else None
        itl_s = None
        if st.t_first_token and st.produced > 1:
            itl_s = (now_ns - st.t_first_token) / 1e9 / (st.produced - 1)
        e2e_s = (now_ns - t0) / 1e9
        met = get_slo_accountant().record(st.req.model, spec, ttft_s=ttft_s, itl_s=itl_s,
                                          output_tokens=st.produced, e2e_s=e2e_s)
        fields: Dict[str, Any] = dict(
            sla_class=spec.sla_class, met=met,
            ttft_ms=None if ttft_s is None else round(ttft_s * 1e3, 3),
            ttft_target_ms=round(spec.ttft_target_s * 1e3, 3),
            itl_ms=None if itl_s is None else round(itl_s * 1e3, 3),
            itl_target_ms=round(spec.itl_target_s * 1e3, 3),
        )
        if spec.deadline_s > 0:
            fields["deadline_remaining_s"] = round(spec.deadline_s - e2e_s, 3)
        if not met or finish_reason == FINISH_ERROR:
            get_flight_recorder().record(st.req.request_id, "slo_violation", **fields)

    def _step_stats(self, phase: str, duration_s: float, tokens: int,
                    passes: int = 1) -> None:
        """Feed one StepStats to ``stats_hook``: scalars the loop already
        holds (engine/telemetry.py); never a device sync."""
        hook = self.stats_hook
        # a chunk-carrying step consumed (or missed) a prebuild
        prep = (self._prep.pop_last()
                if self._prep is not None and phase in ("prefill", "mixed") else None)
        if hook is None:
            return
        spec_acc = self.spec_acceptance() if self._spec else None
        try:
            hook(StepStats(
                phase=phase, duration_s=duration_s,
                batch_occupancy=sum(1 for st in self._slots
                                    if st is not None and not st.done),
                batch_size=self.cfg.max_batch_size, tokens=int(tokens),
                queue_depth=len(self._waiting),
                kv_active_blocks=self.allocator.active_blocks,
                kv_free_blocks=self.allocator.free_blocks,
                kv_total_blocks=self.cfg.num_blocks,
                spec_acceptance=spec_acc,
                prep_hit=prep["hit"] if prep is not None else None,
                prep_build_s=prep["build_s"] if prep is not None else 0.0,
                prep_wait_s=prep["wait_s"] if prep is not None else 0.0,
                passes=passes,
            ))
        except Exception:
            log.exception("stats hook failed")

    def _reap_finished(self) -> None:
        # commit what is written before any block goes back to the pool
        self._commit_written_blocks()
        for i, st in enumerate(self._slots):
            if st is None:
                continue
            if st.done or st.context.is_killed():
                self.allocator.release(st.block_ids)
                self._slots[i] = None
                self._sealed_unwritten = [e for e in self._sealed_unwritten
                                          if e[0] is not st]
                if not st.done:
                    st.done = True
                    st.out_queue.put_nowait(BackendOutput(
                        finish_reason=FINISH_CANCELLED, cumulative_tokens=st.produced,
                    ))
