"""python -m dynamo_tpu_torch.run — drive TorchEngine in one process.

Counterpart of the reference's ``python -m dynamo_tpu.run``: the engine
runs in-process behind the byte tokenizer (the distributed runtime,
preprocessor and HTTP frontend are later slices).

    python -m dynamo_tpu_torch.run in=text:"hello world" out=llama3-8b
    python -m dynamo_tpu_torch.run in=batch:prompts.txt out=llama3-8b --max-tokens 32
    python -m dynamo_tpu_torch.run in=text:hi out=gemma2-2b --max-context 8192
    python -m dynamo_tpu_torch.run in=text:hi out=tiny --device cpu
    python -m dynamo_tpu_torch.run in=text:hi out=tiny-gemma3 --device cpu
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

``out=`` names a preset of either family (llama: tiny, qwen3-0.6b,
llama3-8b, llama3-70b; gemma: tiny-gemma2, tiny-gemma3, gemma2-2b,
gemma3-4b), with random weights from ``--seed``; ``--max-context`` goes up
to the model's ``max_position``. Serves on the GPU by default; ``--device
cpu`` runs the plain PyTorch path on the CPU.
``batch:`` reads one prompt per line and prints one JSON line per prompt.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from typing import List, Optional

from .engine.engine import TorchEngine, TorchEngineConfig
from .kvbm.layout import kv_bytes_per_token
from .kvbm.pool import KvbmTiers
from .llm.protocols.common import PreprocessedRequest, SamplingOptions, StopConditions
from .llm.tokenizer import ByteTokenizer, DecodeStream
from .models.registry import PRESETS
from .runtime.engine import Context


def build_engine(preset: str, device: Optional[str], max_context: int, seed: int,
                 kv_dtype: str = "auto", kvbm_host_gb: float = 0.0,
                 kvbm_disk_gb: float = 0.0,
                 kvbm_disk_path: Optional[str] = None,
                 decode_steps: Optional[int] = None,
                 decode_pipeline: Optional[int] = None) -> TorchEngine:
    if preset not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r} (one of {', '.join(PRESETS)})")
    model = PRESETS[preset]()
    if max_context > model.max_position:
        raise SystemExit(f"--max-context {max_context} exceeds {preset}'s max_position "
                         f"{model.max_position}")
    buckets = tuple(b for b in (64, 128, 256, 512, 1024, 2048) if b < max_context)
    cfg = TorchEngineConfig(
        model=model, max_context=max_context, seed=seed, device=device,
        num_blocks=max(512, (max_context // 16) * 16),
        prefill_buckets=buckets + (max_context,), kv_dtype=kv_dtype,
        decode_steps=decode_steps, decode_pipeline=decode_pipeline,
    )
    kvbm = None
    if kvbm_host_gb > 0 or kvbm_disk_gb > 0:
        # tiers sized in stored bytes per block (model dtype or int8 codec)
        block_nbytes = int(kv_bytes_per_token(cfg.model, cfg.block_size, cfg.kv_dtype)
                           * cfg.block_size)
        kvbm = KvbmTiers(block_nbytes, host_capacity_bytes=int(kvbm_host_gb * (1 << 30)),
                         disk_capacity_bytes=int(kvbm_disk_gb * (1 << 30)),
                         disk_path=kvbm_disk_path)
    return TorchEngine(cfg, kvbm=kvbm)


async def generate_text(engine: TorchEngine, tok: ByteTokenizer, prompt: str,
                        rid: str, max_tokens: int, temperature: float, out=None) -> str:
    """Stream one completion; with ``out`` the text deltas are written as
    they arrive. Returns the whole text."""
    req = PreprocessedRequest(
        request_id=rid, model="run", token_ids=[tok.BOS] + tok.encode(prompt),
        stop=StopConditions(max_tokens=max_tokens, stop_token_ids=[tok.EOS]),
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


async def run(args) -> None:
    kind, _, val = args.input.partition(":")
    if kind not in ("text", "batch"):
        raise SystemExit(f"unknown input {args.input!r} (text:<prompt> | batch:<file>)")
    engine = build_engine(args.out, args.device, args.max_context, args.seed,
                          args.kv_dtype, args.kvbm_host_gb, args.kvbm_disk_gb,
                          args.kvbm_disk_path, args.decode_steps, args.decode_pipeline)
    tok = ByteTokenizer()
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
        usage="python -m dynamo_tpu_torch.run in=<input> out=<preset> [options]",
    )
    p.add_argument("io", nargs=2, metavar="in=|out=",
                   help="in=text:<prompt>|batch:<file>  out=<preset>")
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
    args = p.parse_args(argv)
    spec = dict(part.partition("=")[::2] for part in args.io)
    if "in" not in spec or "out" not in spec:
        p.error("need both in=<input> and out=<preset>")
    args.input, args.out = spec["in"], spec["out"]
    asyncio.run(run(args))


if __name__ == "__main__":
    main()
