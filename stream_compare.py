#!/usr/bin/env python3
"""Token streams of one checkout on one GPU, for holding two commits'
outputs to each other bit for bit (unpack the parent with ``git archive``
into an ignored directory and run parent, change in one session).

    python3 stream_compare.py CHECKOUT

Imports ``dynamo_tpu_torch`` from CHECKOUT, builds its kernels, then
serves llama3-8b (32 layers, random bf16 weights from seed 0) with a
pinned schedule (8 decode steps a horizon, 1 in flight, each a CUDA-graph
replay) on two traffics queued at once: 8 prompts of 128 tokens, 128
tokens each, one of them sampled with a seed (decode-heavy), and 8
prompts of 100-2000 tokens, 32 tokens each (chunked prefill and fused
mixed steps). Prints per traffic the graphs the engine captured, its
step counts and one sha256 over every request's token ids, and writes
the streams to ``chiprun_out/streams_<name of CHECKOUT>.json``.
"""

import asyncio
import hashlib
import json
import os
import sys

import numpy as np
import torch

CHECKOUT = os.path.abspath(sys.argv[1])
sys.path.insert(0, CHECKOUT)
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig  # noqa: E402
from dynamo_tpu_torch.llm.protocols.common import (  # noqa: E402
    PreprocessedRequest, SamplingOptions, StopConditions,
)
from dynamo_tpu_torch.models import registry  # noqa: E402
from dynamo_tpu_torch.models.llama import LlamaConfig  # noqa: E402
from dynamo_tpu_torch.ops import _build  # noqa: E402
from dynamo_tpu_torch.runtime import Context  # noqa: E402

TRAFFIC = {"decode_heavy": ((128,) * 8, 128), "mixed": ((100, 2000, 700, 1500, 300, 1200,
                                                         450, 900), 32)}


def requests(lens, n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, L in enumerate(lens):
        samp = dict(temperature=0.8, seed=7) if i == 3 else dict(temperature=0.0)
        out.append(PreprocessedRequest(
            request_id=f"r{i}", model="m", token_ids=rng.integers(32, 127, size=L).tolist(),
            sampling=SamplingOptions(**samp), stop=StopConditions(max_tokens=n)))
    return out


async def serve(engine, reqs):
    async def one(req):
        toks = []
        async for out in engine.generate(req, Context()):
            toks.extend(out.token_ids)
        return toks

    return await asyncio.gather(*(one(r) for r in reqs))


def main():
    _build.build_all()
    mcfg = LlamaConfig.llama3_8b()
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    result = {}
    for seed, (name, (lens, n)) in enumerate(TRAFFIC.items()):
        engine = TorchEngine(TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=16,
                                               max_batch_size=8, max_context=4096, seed=0,
                                               decode_steps=8, decode_pipeline=1),
                             params=params)
        try:
            streams = asyncio.run(serve(engine, requests(lens, n, seed)))
        finally:
            engine.stop()
        digest = hashlib.sha256(json.dumps(streams).encode()).hexdigest()
        result[name] = {"graphs": engine.horizon_stats()["graphs"],
                        "steps": dict(engine.step_counts), "sha256": digest,
                        "streams": streams}
        print(name, json.dumps({k: v for k, v in result[name].items() if k != "streams"}),
              flush=True)
        del engine
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out",
                           f"streams_{os.path.basename(CHECKOUT) or 'repo'}.json"), "w") as f:
        json.dump(result, f)


if __name__ == "__main__":
    main()
