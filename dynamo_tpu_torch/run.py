"""python -m dynamo_tpu_torch.run — drive TorchEngine in one process.

Counterpart of the reference's ``python -m dynamo_tpu.run``: the engine
runs in-process behind the byte tokenizer. To serve it behind the OpenAI
frontend, start the three processes of the serving plane instead (the
discovery store, a worker, the frontend; README "PyTorch/CUDA port"):

    python -m dynamo_tpu_torch.runtime.discovery.netstore --port 7460
    python -m dynamo_tpu_torch.engine --store tcp --store-path 127.0.0.1:7460 \
        --preset llama3-8b --model llama3-8b
    python -m dynamo_tpu_torch.frontend --store tcp --store-path 127.0.0.1:7460 --port 8000

    python -m dynamo_tpu_torch.run in=text:"hello world" out=llama3-8b
    python -m dynamo_tpu_torch.run in=batch:prompts.txt out=llama3-8b --max-tokens 32
    python -m dynamo_tpu_torch.run in=text:hi out=gemma2-2b --max-context 8192
    python -m dynamo_tpu_torch.run in=text:hi out=gpt-oss-20b --max-context 8192
    python -m dynamo_tpu_torch.run in=text:hi out=deepseek-v2-lite --max-context 8192
    python -m dynamo_tpu_torch.run in=text:hi out=qwen3-30b-a3b
    python -m dynamo_tpu_torch.run in=text:hi out=tiny --device cpu
    python -m dynamo_tpu_torch.run in=text:hi out=tiny-gemma3 --device cpu
    python -m dynamo_tpu_torch.run in=text:hi out=tiny-gptoss --device cpu
    python -m dynamo_tpu_torch.run in=text:hi out=tiny-mla-moe --device cpu
    python -m dynamo_tpu_torch.run in=text:hi out=tiny-vl --device cpu
    python -m dynamo_tpu_torch.run in=text:hi out=tiny --spec-draft tiny --spec-k 3 \
        --device cpu
    python -m dynamo_tpu_torch.run in=batch:prompts.txt out=llama3-8b \
        --kv-dtype int8 --kvbm-host-gb 4

``--kv-dtype int8`` stores the paged KV cache as int8 with per-block
scales; ``--kvbm-host-gb`` / ``--kvbm-disk-gb`` write sealed KV blocks
through to a host-memory (G2) and a disk (G3) tier and onboard a cached
prefix from them, as the reference's worker flags of the same names do.

``--decode-steps N`` runs N decode steps per dispatch (the decode
horizon; on the GPU each horizon replays a CUDA graph captured at start)
and ``--decode-pipeline D`` keeps D horizons in flight; both default to
the engine's auto-tuned schedule, and ``--decode-steps 1`` runs one eager
step per tick, as the reference's worker flags of the same names do.

``--spec-draft PRESET`` serves with speculative decoding, a draft of that
preset's architecture (random weights from ``--seed`` + 2) drafting
``--spec-k`` tokens a round (default 4, capped at the decode horizon), as
the reference worker's flags of the same names do: greedy requests ride
spec rounds, others fall back to normal horizons. Main and draft are of
the llama family; on the GPU the draft takes head_dim 128.

``out=tiny-vl`` is the tiny llama preset with a tiny vision tower
(``VisionConfig.tiny``, random weights from ``--seed`` + 1), as the
reference's ``tiny-vl``: the engine takes image parts (the ``images``
annotation); text prompts through this CLI serve as on ``tiny``.

``out=`` names a HuggingFace checkpoint directory, or an ``org/name``
reference found in the HF hub cache (llm/hub.py), of any family the
loader maps (engine/weights.py); it loads through the warm weight cache
(engine/warm.py; ``--no-warm-cache`` parses the checkpoint every time) and
encodes with the checkpoint's own tokenizer (``--tokenizer`` picks
another: ``byte``, or a directory; the HF tokenizer needs
``transformers``). A prompt is the tokenizer's BOS, when it has one,
then the prompt's ids; the EOS stops it. ``--spec-draft-path DIR`` loads
a speculative draft from a checkpoint likewise.

    python -m dynamo_tpu_torch.run in=text:hi out=/models/Qwen3-0.6B
    python -m dynamo_tpu_torch.run in=text:hi out=Qwen/Qwen3-0.6B --tokenizer byte
    python -m dynamo_tpu_torch.run in=text:hi out=/ckpt --device cpu --no-warm-cache

Or ``out=`` names a preset of any family (llama: tiny, qwen3-0.6b,
llama3-8b, llama3-70b; gemma: tiny-gemma2, tiny-gemma3, gemma2-2b,
gemma3-4b; gpt-oss: tiny-gptoss, gpt-oss-20b; Qwen3-MoE: tiny-moe,
qwen3-30b-a3b; MLA: tiny-mla, tiny-mla-moe, deepseek-v2-lite, and
deepseek-v3 as a configuration that no one card holds), with random
weights from ``--seed`` (gpt-oss-20b: 41.8 GB in bf16, deepseek-v2-lite
31.4 GB, qwen3-30b-a3b 61 GB); ``--max-context`` goes up to the model's
``max_position``. An MLA model takes no ``--kv-dtype int8``. Serves on the GPU by default; ``--device
cpu`` runs the plain PyTorch path on the CPU.
``batch:`` reads one prompt per line and prints one JSON line per prompt.

``--tp N`` serves a dense llama-family model from a tensor-parallel group
of N processes on this host (runtime/multihost.py): this process leads and
starts N-1 followers of this module (the same arguments plus
``--multihost``), each holding its shard of the weights and replaying the
leader's device ops; ranks that share a card run their horizons eagerly.

    python -m dynamo_tpu_torch.run in=text:hi out=llama3-8b --tp 2
    python -m dynamo_tpu_torch.run in=text:hi out=tiny --tp 2 --device cpu
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import sys
from typing import List, Optional

from .engine.engine import TorchEngine, TorchEngineConfig
from .engine.warm import load_params_warm
from .engine.weights import config_from_hf, load_params, shard_params
from .kvbm.layout import kv_bytes_per_token
from .kvbm.pool import KvbmTiers
from .llm.hub import resolve_model_path
from .llm.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from .llm.tokenizer import DecodeStream, Tokenizer, load_tokenizer
from .models.llama import LlamaConfig
from .models.registry import PRESETS
from .models.vision import VisionConfig
from .runtime.engine import Context


# language presets with a vision tower: (language preset, tower for its hidden size)
VISION_PRESETS = {
    "tiny-vl": ("tiny", lambda m: VisionConfig.tiny(out_hidden_size=m.hidden_size)),
}


def is_preset(name: str) -> bool:
    return name in PRESETS or name in VISION_PRESETS


def _model_of(preset: str) -> LlamaConfig:
    name = VISION_PRESETS[preset][0] if preset in VISION_PRESETS else preset
    if name not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r} (one of "
                         f"{', '.join(list(PRESETS) + list(VISION_PRESETS))})")
    return PRESETS[name]()


def load_checkpoint(ref: str, device: Optional[str], warm: bool = True,
                    weight_service: Optional[str] = None):
    """(directory, config, parameters on ``device``, the weight owner's
    lease or None) of a checkpoint directory or hub reference: imported
    from the weight owner on the unix socket ``weight_service``
    (engine/weight_service.py) when it answers, else through the warm cache
    unless ``warm`` is off."""
    path = resolve_model_path(ref)
    cfg = config_from_hf(path)
    lease = None
    if weight_service:
        from .engine.weight_service import load_params_served

        params, lease = load_params_served(path, cfg, weight_service, warm_fallback=warm,
                                           device=device)
    elif warm:
        params = load_params_warm(path, cfg, device=device)
    else:
        params = load_params(path, cfg, device)
    return path, cfg, params, lease


def build_engine(out: str, device: Optional[str], max_context: int, seed: int,
                 kv_dtype: str = "auto", kvbm_host_gb: float = 0.0,
                 kvbm_disk_gb: float = 0.0,
                 kvbm_disk_path: Optional[str] = None,
                 decode_steps: Optional[int] = None,
                 decode_pipeline: Optional[int] = None,
                 spec_draft: Optional[str] = None, spec_k: int = 4,
                 spec_draft_path: Optional[str] = None,
                 warm_cache: bool = True,
                 num_blocks: Optional[int] = None, block_size: int = 16,
                 max_batch_size: int = 8, prefill_chunk: Optional[int] = None,
                 guided_vocab=None, kvbm_remote: Optional[str] = None,
                 weight_service: Optional[str] = None, tp: int = 1, multihost=None,
                 num_layers: Optional[int] = None, **features) -> TorchEngine:
    """The engine for ``out``, a preset (random weights from ``seed``) or
    a checkpoint directory / hub reference. ``num_blocks`` defaults to
    the context's worth of blocks (at least 512) and ``prefill_chunk``
    (the largest prefill dispatch) to ``max_context``; ``features`` are
    TorchEngineConfig's feature fields (guided caps, logits processors,
    LoRA slots), ``guided_vocab`` the constructor's. ``kvbm_remote``
    (``host:port``) writes sealed blocks through to a G4 block store
    (kvbm/remote.py) and onboards from it. ``weight_service`` (a unix
    socket) imports a checkpoint's weights from a weight owner; the
    engine's ``weight_lease`` then holds the connection, its lease.
    ``num_layers`` cuts a preset to its first layers.

    ``tp`` > 1 builds this process's rank of a joined TP group
    (``multihost``, runtime/multihost.py): a preset draws the rank's shard
    of the seed's weights; a checkpoint is loaded whole on the host and
    sliced to the rank's shard (engine/weights.shard_params) before it
    goes to ``device``. Ranks that share a card (collectives through the
    host) run their horizons eagerly, which is printed."""
    params = draft_params = lease = None
    if is_preset(out):
        model = _model_of(out)
        if num_layers:
            model = dataclasses.replace(model, num_layers=num_layers)
    elif num_layers:
        raise SystemExit("--num-layers cuts a preset, not a checkpoint")
    elif tp > 1:
        if weight_service:
            raise ValueError(f"--tp {tp} does not import from a weight owner yet "
                             "(ROADMAP.md Queue 1 item 6)")
        _, model, whole, _ = load_checkpoint(out, "cpu", warm_cache)
        rank = multihost.spec.process_id if multihost is not None else 0
        params = _to_device(shard_params(whole, model, rank, tp), device)
        del whole
    else:
        _, model, params, lease = load_checkpoint(out, device, warm_cache, weight_service)
    vision = VISION_PRESETS[out][1](model) if out in VISION_PRESETS else None
    draft = _model_of(spec_draft) if spec_draft else None
    if spec_draft_path:
        _, draft, draft_params, _ = load_checkpoint(spec_draft_path, device, warm_cache)
    if max_context > model.max_position:
        raise SystemExit(f"--max-context {max_context} exceeds {out}'s max_position "
                         f"{model.max_position}")
    chunk = min(prefill_chunk or max_context, max_context)
    buckets = tuple(b for b in (64, 128, 256, 512, 1024, 2048) if b < chunk)
    if tp > 1 and multihost is not None and multihost.comm is not None \
            and multihost.comm.host_staged:
        features.setdefault("cuda_graphs", False)
        print(f"tp {tp}: ranks share a card ({multihost.comm.backend} copies each collective "
              "through the host): horizons run eagerly (cuda_graphs off)\n", end="", flush=True)
    cfg = TorchEngineConfig(
        model=model, max_context=max_context, seed=seed, device=device, tp=tp,
        num_blocks=num_blocks or max(512, (max_context // 16) * 16),
        block_size=block_size, max_batch_size=max_batch_size,
        prefill_buckets=buckets + (chunk,), kv_dtype=kv_dtype,
        decode_steps=decode_steps, decode_pipeline=decode_pipeline,
        vision=vision, spec_draft=draft, spec_k=spec_k, **features,
    )
    kvbm = None
    if kvbm_host_gb > 0 or kvbm_disk_gb > 0 or kvbm_remote:
        # tiers sized in stored bytes per block (model dtype or int8 codec)
        block_nbytes = int(kv_bytes_per_token(cfg.model, cfg.block_size, cfg.kv_dtype)
                           * cfg.block_size)
        remote = None
        if kvbm_remote:
            from .kvbm.remote import RemoteBlockPool

            remote = RemoteBlockPool(kvbm_remote)
        kvbm = KvbmTiers(block_nbytes, host_capacity_bytes=int(kvbm_host_gb * (1 << 30)),
                         disk_capacity_bytes=int(kvbm_disk_gb * (1 << 30)),
                         disk_path=kvbm_disk_path, remote=remote)
    engine = TorchEngine(cfg, params=params, kvbm=kvbm, draft_params=draft_params,
                         guided_vocab=guided_vocab, multihost=multihost)
    engine.weight_lease = lease
    return engine


def _to_device(params, device):
    """A parameter tree's tensors moved to ``device``."""
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_to_device(v, device) for v in params]
    return params.to(device)


def prompt_ids(tok: Tokenizer, prompt: str) -> List[int]:
    """The tokenizer's BOS, when it has one, then the prompt's ids."""
    bos = [tok.bos_token_id] if tok.bos_token_id is not None else []
    return bos + tok.encode(prompt)


async def generate_text(engine: TorchEngine, tok: Tokenizer, prompt: str,
                        rid: str, max_tokens: int, temperature: float, out=None) -> str:
    """Stream one completion; with ``out`` the text deltas are written as
    they arrive. Returns the whole text."""
    eos = [tok.eos_token_id] if tok.eos_token_id is not None else []
    req = PreprocessedRequest(
        request_id=rid, model="run", token_ids=prompt_ids(tok, prompt),
        stop=StopConditions(max_tokens=max_tokens, stop_token_ids=eos),
        sampling=SamplingOptions(temperature=temperature),
    )
    stream = DecodeStream(tok)
    parts: List[str] = []
    async for item in engine.generate(req, Context(rid)):
        delta = stream.step(item.token_ids)
        if delta:
            parts.append(delta)
            if out is not None:
                out.write(delta)
                out.flush()
    parts.append(stream.flush())
    return "".join(parts)


async def run(args, mh=None) -> None:
    kind, _, val = args.input.partition(":")
    if kind not in ("text", "batch"):
        raise SystemExit(f"unknown input {args.input!r} (text:<prompt> | batch:<file>)")
    engine = build_engine(args.out, args.device, args.max_context, args.seed,
                          args.kv_dtype, args.kvbm_host_gb, args.kvbm_disk_gb,
                          args.kvbm_disk_path, args.decode_steps, args.decode_pipeline,
                          args.spec_draft, args.spec_k, args.spec_draft_path,
                          not args.no_warm_cache, tp=args.tp, multihost=mh)
    if mh is not None and not mh.is_leader:
        engine.follow()
        return
    tok_ref = args.tokenizer or ("byte" if is_preset(args.out) else resolve_model_path(args.out))
    tok = load_tokenizer(tok_ref)
    try:
        if kind == "text":
            await generate_text(engine, tok, val, "text", args.max_tokens,
                                args.temperature, out=sys.stdout)
            print()
        else:
            with open(val) as f:
                prompts = [line.rstrip("\n") for line in f if line.strip()]
            for n, prompt in enumerate(prompts):
                text = await generate_text(engine, tok, prompt, f"batch-{n}",
                                           args.max_tokens, args.temperature)
                print(json.dumps({"index": n, "prompt": prompt, "text": text}))
    finally:
        engine.stop()


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser(
        "dynamo_tpu_torch.run",
        usage="python -m dynamo_tpu_torch.run in=<input> out=<preset|checkpoint> [options]",
    )
    p.add_argument("io", nargs=2, metavar="in=|out=",
                   help="in=text:<prompt>|batch:<file>  out=<preset>|<checkpoint dir>|<org/name>")
    p.add_argument("--device", default=None, help="default: cuda; 'cpu' for the CPU")
    p.add_argument("--max-tokens", type=int, default=64)
    p.add_argument("--max-context", type=int, default=2048)
    p.add_argument("--temperature", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0, help="random-weight seed")
    p.add_argument("--kv-dtype", default="auto", choices=("auto", "model", "int8"),
                   help="paged-KV storage: int8 = int8 pages with per-block "
                        "scales; auto defers to DTPU_KV_DTYPE (default: the "
                        "model dtype)")
    p.add_argument("--kvbm-host-gb", type=float, default=0.0,
                   help="host memory KV tier size (G2); 0 with --kvbm-disk-gb "
                        "0 disables KVBM")
    p.add_argument("--kvbm-disk-gb", type=float, default=0.0,
                   help="disk KV tier size (G3)")
    p.add_argument("--kvbm-disk-path", default=None,
                   help="G3 spill directory (default: <tmpdir>/dtpu_kvbm)")
    p.add_argument("--decode-steps", type=int, default=None,
                   help="decode steps per dispatch (the decode horizon; default: "
                        "auto-tuned from the measured device round trip)")
    p.add_argument("--decode-pipeline", type=int, default=None,
                   help="decode horizons in flight (default: auto-tuned with "
                        "--decode-steps)")
    p.add_argument("--spec-draft", default=None, metavar="PRESET",
                   help="speculative decoding with a draft of this preset's "
                        "architecture (random weights); greedy requests ride "
                        "spec rounds, others fall back per dispatch")
    p.add_argument("--spec-draft-path", default=None, metavar="DIR",
                   help="speculative decoding with a draft loaded from this "
                        "checkpoint directory or hub reference")
    p.add_argument("--tokenizer", default=None,
                   help="'byte', or a tokenizer directory (default: the "
                        "checkpoint's own; byte for a preset)")
    p.add_argument("--no-warm-cache", action="store_true",
                   help="parse the checkpoint on every start (skip the warm "
                        "weight cache, $DTPU_WARM_CACHE or "
                        "~/.cache/dynamo_tpu_torch/warm)")
    p.add_argument("--spec-k", type=int, default=4,
                   help="draft tokens per speculative round (capped at the "
                        "decode steps)")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ranks: a group of this many processes on this "
                        "host (dense llama family)")
    p.add_argument("--multihost", default=None, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    spec = dict(part.partition("=")[::2] for part in args.io)
    if "in" not in spec or "out" not in spec:
        p.error("need both in=<input> and out=<preset|checkpoint>")
    args.input, args.out = spec["in"], spec["out"]
    if args.tp == 1:
        asyncio.run(run(args))
        return
    from .runtime.multihost import join_group, reap

    mh, device, followers = join_group(args.tp, args.multihost, "dynamo_tpu_torch.run",
                                       list(sys.argv[1:] if argv is None else argv),
                                       args.device)
    args.device = str(device)
    try:
        asyncio.run(run(args, mh))
    finally:
        mh.close()
        reap(followers)
        mh.shutdown()


if __name__ == "__main__":
    main()
