"""One rank of a tensor-parallel TorchEngine group on the CPU (not a test
module): tests/test_torch_tp.py starts one process per rank.

    python tests/torch_tp_rank.py SPEC SETUP.json WEIGHTS.npz OUT.json
    python tests/torch_tp_rank.py --collectives SPEC OUT.json

SPEC is the rank's ``--multihost`` text; SETUP.json holds the model and
engine fields and the KV dtype; WEIGHTS.npz the whole model's parameters
(the reference's tree, flattened as ``embed``, ``layers.3.wq``, ...). Each
rank serves its shard (engine/weights.shard_params). The leader runs
``scenarios`` and writes their streams, its collectives and the digest of
the tokens its ops sampled to OUT.json; a follower replays the leader's
ops and writes its collectives and digest. The scenarios also serve the
reference's engine in the test process (``Side`` takes either package's
request types). With ``--collectives`` each rank reduces and gathers
inputs of its own (float32 and bf16) and writes them with the results.
"""

import asyncio
import json
import os
import sys

import numpy as np

SAMPLED = dict(temperature=0.8, top_p=0.95, seed=7)


def prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


class Side:
    """One engine behind the scenarios, with its package's request types."""

    def __init__(self, engine, req_cls, samp_cls, stop_cls, ctx_cls):
        self.engine = engine
        self.req, self.samp, self.stop, self.ctx = req_cls, samp_cls, stop_cls, ctx_cls

    async def run(self, rid, tokens, max_tokens=8, on_first=None, **sampling):
        req = self.req(
            request_id=rid, model="m", token_ids=list(tokens),
            stop=self.stop(max_tokens=max_tokens),
            sampling=self.samp(**(sampling or {"temperature": 0.0})),
        )
        toks, cached, finish = [], None, None
        async for out in self.engine.generate(req, self.ctx()):
            toks.extend(out.token_ids)
            if "cached_tokens" in (out.annotations or {}):
                cached = out.annotations["cached_tokens"]
            if toks and on_first is not None and not on_first.is_set():
                on_first.set()
            finish = out.finish_reason or finish
        return {"tokens": toks, "cached": cached, "finish": finish}


async def scenarios(side: Side) -> dict:
    """A prompt of three prefill chunks; the same prompt again (a prefix
    hit); a resident decode while three prompts prefill (fused mixed
    steps, then horizons); a seeded sampled request."""
    out = {"chunked": await side.run("chunked", prompt(11, 150), max_tokens=9)}
    out["repeat"] = await side.run("repeat", prompt(11, 150), max_tokens=5)
    started = asyncio.Event()
    lead = asyncio.ensure_future(side.run("lead", prompt(2, 9), max_tokens=24,
                                          on_first=started))
    await started.wait()
    rest = await asyncio.gather(side.run("b", prompt(3, 70), max_tokens=10),
                                side.run("c", prompt(4, 33), max_tokens=12),
                                side.run("d", prompt(5, 130), max_tokens=6))
    out["staggered"] = [await lead] + list(rest)
    out["sampled"] = await side.run("sampled", prompt(6, 20), max_tokens=12, **SAMPLED)
    return out


def tree_from_npz(path: str) -> dict:
    """The flattened weights back to the reference's tree."""
    flat = np.load(path)
    tree = {"layers": []}
    for key in flat.files:
        parts = key.split(".")
        if parts[0] == "layers":
            i = int(parts[1])
            while len(tree["layers"]) <= i:
                tree["layers"].append({})
            tree["layers"][i][parts[2]] = flat[key]
        else:
            tree[key] = flat[key]
    return tree


def main(spec: str, setup_path: str, weights_path: str, out_path: str) -> None:
    import torch

    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.engine.weights import params_from_numpy, shard_params
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest,
        SamplingOptions,
        StopConditions,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.parallel.mesh import local_config
    from dynamo_tpu_torch.runtime import Context
    from dynamo_tpu_torch.runtime.multihost import MultihostContext, MultihostSpec

    torch.set_num_threads(1)
    with open(setup_path) as f:
        setup = json.load(f)
    mh = MultihostContext(MultihostSpec.parse(spec))
    tp, rank = mh.num_processes, mh.spec.process_id
    mh.initialize(torch.device("cpu"))
    mh.start_control()
    cfg = LlamaConfig(dtype=torch.float32, **setup["model"])
    shard = shard_params(tree_from_npz(weights_path), cfg, rank, tp)
    engine = TorchEngine(
        TorchEngineConfig(model=cfg, device="cpu", tp=tp, kv_dtype=setup["kv_dtype"],
                          **setup["engine"]),
        params=params_from_numpy(shard, local_config(cfg, tp), device="cpu"),
        multihost=mh)
    report = {"rank": rank}
    if mh.is_leader:
        side = Side(engine, PreprocessedRequest, SamplingOptions, StopConditions, Context)
        report["streams"] = asyncio.run(scenarios(side))
        report["steps"] = dict(engine.step_counts)
        engine.stop()
    else:
        engine.follow()
        report["steps"] = dict(engine.step_counts)
    report["collectives"] = dict(mh.comm.counts)
    report["sampled"] = engine.sampled_digest()
    mh.close()
    mh.shutdown()
    with open(out_path + ".tmp", "w") as f:
        json.dump(report, f)
    os.replace(out_path + ".tmp", out_path)


def collectives(spec: str, out_path: str) -> None:
    import torch

    from dynamo_tpu_torch.runtime.multihost import MultihostContext, MultihostSpec

    mh = MultihostContext(MultihostSpec.parse(spec))
    comm = mh.initialize(torch.device("cpu"))
    rng = np.random.default_rng(100 + comm.rank)
    x32 = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32))
    xbf = torch.from_numpy(rng.standard_normal((8, 64)).astype(np.float32)).bfloat16()
    report = {"inputs": {"float32": x32.tolist(), "bf16": xbf.float().tolist()},
              "all_reduce": {"float32": comm.all_reduce(x32.clone()).tolist(),
                             "bf16": comm.all_reduce(xbf).float().tolist()},
              "all_gather": {"float32": comm.all_gather(x32).tolist()}}
    mh.shutdown()
    with open(out_path, "w") as f:
        json.dump(report, f)


if __name__ == "__main__":
    if sys.argv[1] == "--collectives":
        collectives(*sys.argv[2:4])
    else:
        main(*sys.argv[1:5])
