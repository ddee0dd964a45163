"""The port's runtime/multihost.py against the reference's, and a ``--tp 2``
worker behind the port's frontend on the CPU.

- Frames: the port's dispatch frames are byte-equal to the reference's
  (``msgpack`` of ``_encode_arg``) for the same numpy arguments, scalars
  and carry sentinels, through each side's ``leader_fn``; both decode them
  alike; ``MultihostSpec.parse`` reads specs as the reference's does.
- Replay: a leader and a follower in one process, over the real control
  channel: each op is replayed in order, a chained carry substitutes the
  follower's own, and a follower that closes its channel fires
  ``watch_followers``.
- The worker: ``python -m dynamo_tpu_torch.engine --tp 2`` (CPU, one
  follower process it starts) on a checkpoint serves a completion whose
  tokens are the in-process reference ``TpuEngine``'s (and its logprobs
  within bf16 rounding); its
  ``/debug/worker`` and ``/metadata`` say ``tp`` 2; killing the follower
  takes the worker out of discovery.
- Refusals: each combination a TP group does not serve yet raises a
  ``ValueError`` naming ROADMAP.md Queue 1 item 6 (engine, worker flags,
  the engine's transfer and checkpoint entries), ``cuda_graphs`` over a
  host-staged collective too; the worker's step floor prices one rank.
"""

import asyncio
import http.client
import json
import os
import signal
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.ops import costs as jcosts
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu.runtime import multihost as jmh
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
from dynamo_tpu_torch.models import registry as tregistry
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.runtime import multihost as tmh
from dynamo_tpu_torch.runtime.codec import unpackb

import torch_hf_ckpt as ck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUE = "ROADMAP.md Queue 1 item 6"
TINY = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
            head_dim=16, intermediate_size=128)


# ------------------------------------------------------------------ frames
class _Capture:
    """A stand-in context whose broadcast keeps (op, args)."""

    def __init__(self):
        self.sent = []

    def broadcast(self, op, args):
        self.sent.append((op, list(args)))


def _router(module, mh):
    router = module.MultihostRouter.__new__(module.MultihostRouter)
    router.mh, router._tables, router._closed = mh, {}, False
    router.dispatch_lock = threading.Lock()
    return router


ARGS = [
    (np.arange(12, dtype=np.int64).reshape(3, 4), np.zeros(5, np.int32), 7, 0.25, None, True),
    (np.float32(1.5), np.int32(3), np.bool_(True), np.array(4, np.int64)),
    (np.random.default_rng(0).standard_normal((70, 300)).astype(np.float32),   # bin32
     np.ones((2, 3), np.bool_), np.arange(6, dtype=np.uint8), np.int8(-3)),
    ([1, 2, 3], (4.0, 5.0), np.arange(3, dtype=np.float64)),
]


@pytest.mark.parametrize("args", ARGS, ids=["arrays_scalars", "numpy_scalars", "large",
                                             "sequences"])
def test_frames_are_byte_equal_to_the_references(args):
    frames = {}
    for name, module, device_arg in (("ref", jmh, jnp.zeros(3)), ("port", tmh, torch.zeros(3))):
        mh = _Capture()
        ops = module.MultihostOps(_router(module, mh), "ns", {}, {})
        ops.register("op", lambda *a: len(a), {}, {}, {len(args): "carry_x"})
        assert ops.leader_fn("op")(*args, device_arg) == len(args) + 1
        (op, sent), = mh.sent
        frames[name] = sent
        assert op == "ns:op"
    ref = msgpack.packb({"op": "ns:op", "a": [jmh._encode_arg(a) for a in frames["ref"]]},
                        use_bin_type=True)
    port = tmh.encode_frame("ns:op", frames["port"])
    assert port[4:] == ref and int.from_bytes(port[:4], "big") == len(ref)
    assert frames["port"][-1] == {"__carry__": "carry_x"}
    # both sides decode the frame to the same values
    got = [tmh._decode_arg(a) for a in unpackb(ref)["a"]]
    want = [jmh._decode_arg(a) for a in msgpack.unpackb(ref, raw=False)["a"]]
    for g, w in zip(got, want):
        if isinstance(w, (np.ndarray, np.generic)):
            assert g.dtype == w.dtype and np.array_equal(g, w)
        else:
            assert g == w


@pytest.mark.parametrize("text", ["10.0.0.1:7000,4,2", "host:99,2,0,ctl:5",
                                  "127.0.0.1:1234,8,7,127.0.0.1:1240"])
def test_specs_parse_as_the_references(text):
    got, want = tmh.MultihostSpec.parse(text), jmh.MultihostSpec.parse(text)
    assert (got.coordinator, got.num_processes, got.process_id, got.control) == (
        want.coordinator, want.num_processes, want.process_id, want.control)
    assert tmh.MultihostSpec.parse(got.text()) == got
    with pytest.raises(ValueError):
        tmh.MultihostSpec.parse("host:1,2")


# ------------------------------------------------------------------ replay
def test_a_follower_replays_in_order_and_a_closed_follower_is_noticed():
    specs = tmh.local_group_specs(2)
    leader, follower = tmh.MultihostContext(specs[0]), tmh.MultihostContext(specs[1])
    dialed = threading.Thread(target=follower.start_control)
    dialed.start()
    leader.start_control()
    dialed.join(10)
    seen = {"leader": [], "follower": []}
    carry = torch.arange(3)

    def tables(who, mh):
        def step(x, state):
            seen[who].append((x.tolist(), state.tolist()))
            return x.sum(), state + 1

        ops = mh.router.table({}, {})
        ops.register("step", step, state_out={1: "carry_s"}, carry_in={1: "carry_s"})
        return ops

    lops, fops = tables("leader", leader), tables("follower", follower)
    runner = threading.Thread(target=fops.follow)
    runner.start()
    fn = lops.leader_fn("step")
    _, state = fn(np.array([1, 2]), carry.numpy())     # a host carry: by value
    fn(np.array([3]), torch.from_numpy(state))          # a device carry: the sentinel
    lops.close()                                        # __stop__
    runner.join(10)
    assert not runner.is_alive()
    assert seen["follower"] == seen["leader"] == [([1, 2], [0, 1, 2]), ([3], [1, 2, 3])]
    # a follower whose channel closes fires the leader's watch
    specs = tmh.local_group_specs(2)
    leader, follower = tmh.MultihostContext(specs[0]), tmh.MultihostContext(specs[1])
    dialed = threading.Thread(target=follower.start_control)
    dialed.start()
    leader.start_control()
    dialed.join(10)
    died = threading.Event()
    leader.watch_followers(died.set)
    follower._sock.close()
    assert died.wait(10)
    leader.close()


# ------------------------------------------------------------------ worker
def _wait_line(proc, prefix, timeout=120.0, seen=None):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError(f"exited ({proc.poll()}) before {prefix}")
        if seen is not None:
            seen.append(line)
        if line.startswith(prefix):
            return line.strip()
    raise AssertionError(f"no {prefix} in {timeout} s")


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", path)
    return json.loads(conn.getresponse().read())


# how long discovery may take to add or drop the worker under the test
# runner's parallel load
DISCOVERY_S = 60.0


def _models_until(port, listed: bool) -> None:
    deadline = time.monotonic() + DISCOVERY_S
    while bool(_get(port, "/v1/models")["data"]) != listed:
        if time.monotonic() > deadline:
            raise AssertionError(f"the frontend {'never listed' if listed else 'still lists'} "
                                 f"the tp worker's model after {DISCOVERY_S} s")
        time.sleep(0.05)


def _reference(ckpt, prompt, n):
    jcfg = jweights.config_from_hf(ckpt)

    async def main():
        engine = TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, max_context=256, num_blocks=64,
                            prefill_buckets=(64, 128, 256), decode_steps=1),
            params=jweights.load_params(ckpt, jcfg),
            mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        req = JRequest(request_id="r", model="m", token_ids=prompt,
                       stop=JStop(max_tokens=n), sampling=JSampling(temperature=0.0, logprobs=1))
        toks, lps = [], []
        try:
            async for o in engine.generate(req, JContext()):
                toks += o.token_ids
                lps += o.logprobs or []
        finally:
            engine.stop()
        return toks, lps

    return asyncio.run(main())


def test_tp2_worker_serves_the_references_tokens_and_leaves_discovery_with_its_follower(
        tmp_path):
    ckpt = ck.llama(str(tmp_path / "ckpt"), "llama", vocab=512)
    prompt = [ByteTokenizer.BOS] + list(b"tensor parallel")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "DTPU_HUB_OFFLINE": "1", "OMP_NUM_THREADS": "1"}
    procs = []

    def start(*args):
        p = subprocess.Popen([sys.executable, "-m", *args], cwd=str(tmp_path), env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append(p)
        return p

    try:
        store = start("dynamo_tpu_torch.runtime.discovery.netstore", "--host", "127.0.0.1",
                      "--port", "0")
        addr = _wait_line(store, "KVSTORE_READY").split()[1]
        common = ("--store", "tcp", "--store-path", addr)
        worker = start("dynamo_tpu_torch.engine", *common, "--model-path", ckpt,
                       "--tokenizer", "byte", "--model", "tp-model", "--tp", "2",
                       "--device", "cpu", "--max-context", "256", "--num-blocks", "64",
                       "--decode-steps", "4", "--decode-pipeline", "1", "--no-warm-cache",
                       "--system-port", "0")
        front = start("dynamo_tpu_torch.frontend", *common, "--host", "127.0.0.1",
                      "--port", "0")
        want_toks, want_lps = _reference(ckpt, prompt, 8)
        port = int(_wait_line(front, "TORCH_FRONTEND_READY").rsplit(":", 1)[1])
        lines = []
        status = _wait_line(worker, "TORCH_STATUS_ADDRESS", seen=lines).split()[1]
        _wait_line(worker, "TORCH_ENGINE_READY", seen=lines)
        groups = [ln for ln in lines if ln.startswith("TP_GROUP")]
        assert len(groups) == 2 and all("backend=gloo" in ln for ln in groups), groups
        follower_pid = int(next(ln for ln in groups if "rank=1/2" in ln)
                           .split("pid=")[1].split()[0])
        status_port = int(status.rsplit(":", 1)[1])
        assert _get(status_port, "/debug/worker")["tp"] == 2
        assert _get(status_port, "/metadata")["tp"] == 2
        _models_until(port, listed=True)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/completions", json.dumps({
            "model": "tp-model", "prompt": prompt, "max_tokens": 8, "temperature": 0,
            "ignore_eos": True, "logprobs": 0}), {"Content-Type": "application/json"})
        resp = conn.getresponse()
        body = json.loads(resp.read())
        assert resp.status == 200, body
        logprobs = body["choices"][0]["logprobs"]
        tok = ByteTokenizer()
        assert logprobs["tokens"] == [tok.decode([t], skip_special_tokens=False)
                                      for t in want_toks]
        # a checkpoint serves in the config's bf16 on both sides: the two
        # frameworks' bf16 logits differ by bf16 rounding (2^-8 relative)
        np.testing.assert_allclose(logprobs["token_logprobs"], want_lps, atol=5e-2)
        # a dead follower takes the worker out of discovery, and it exits
        os.kill(follower_pid, signal.SIGKILL)
        _models_until(port, listed=False)
        assert worker.wait(60) is not None
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(15)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


# ---------------------------------------------------------------- refusals
def _staged_group(backend="gloo"):
    comm = types.SimpleNamespace(backend=backend, host_staged=backend == "gloo")
    return types.SimpleNamespace(comm=comm, num_processes=2, spec=types.SimpleNamespace(
        process_id=0))


def _config(**kw):
    model = kw.pop("model", LlamaConfig(**TINY))
    return TorchEngineConfig(model=model, device=kw.pop("device", "cpu"), tp=2,
                             decode_steps=1, decode_pipeline=1, **kw)


REFUSED = {
    "gemma": lambda: dict(config=_config(model=tregistry.PRESETS["tiny-gemma3"]())),
    "gptoss": lambda: dict(config=_config(model=tregistry.PRESETS["tiny-gptoss"]())),
    "moe": lambda: dict(config=_config(model=tregistry.PRESETS["tiny-moe"]())),
    "mla": lambda: dict(config=_config(model=tregistry.PRESETS["tiny-mla"]())),
    "spec": lambda: dict(config=_config(spec_draft=LlamaConfig(**TINY))),
    "lora": lambda: dict(config=_config(lora_max_adapters=2)),
    "vision": lambda: dict(config=_config(vision=__import__(
        "dynamo_tpu_torch.models.vision", fromlist=["VisionConfig"]).VisionConfig.tiny(
            out_hidden_size=64))),
    "guided": lambda: dict(config=_config(guided_max_states=64),
                           guided_vocab=([b"a"] * 512, 1)),
    "processors": lambda: dict(config=_config(logits_processors=(("id", lambda x: x),))),
    "kvbm": lambda: dict(config=_config(), kvbm=object()),
    "cuda_graphs_over_gloo": lambda: dict(config=_config(device="cuda", cuda_graphs=True),
                                          multihost=_staged_group()),
    "no_group": lambda: dict(config=_config()),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_each_combination_a_tp_group_does_not_serve_is_refused(case):
    kw = REFUSED[case]()
    config = kw.pop("config")
    with pytest.raises(ValueError) as e:
        TorchEngine(config, **kw)
    if case == "no_group":
        assert "multihost" in str(e.value)
    else:
        assert QUEUE in str(e.value)
    if case == "cuda_graphs_over_gloo":
        assert "cuda_graphs=False" in str(e.value)


@pytest.mark.parametrize("flags", [("--disagg", "prefill"), ("--kvbm-host-gb", "1"),
                                   ("--weight-service", "/tmp/sock", "--model-path", "x")])
def test_the_worker_refuses_at_tp_what_a_group_does_not_serve(flags):
    from dynamo_tpu_torch.engine.__main__ import join_tp_group, parse_args

    args = parse_args(["--tp", "2", "--device", "cpu", *flags])
    with pytest.raises(ValueError, match=QUEUE):
        join_tp_group(args, [])
    assert args.guided_max_states == 0 and parse_args([]).guided_max_states == 1024


def test_the_engines_transfer_and_checkpoint_entries_refuse_at_tp(tmp_path):
    from dynamo_tpu_torch.engine.checkpoint import checkpoint_engine, restore_engine

    rank = types.SimpleNamespace(tp=2)
    rank._refuse_at_tp = lambda what: TorchEngine._refuse_at_tp(rank, what)
    for entry in (lambda: asyncio.run(checkpoint_engine(rank, str(tmp_path))),
                  lambda: asyncio.run(restore_engine(rank, str(tmp_path))),
                  lambda: asyncio.run(TorchEngine.serve_transfer(rank)),
                  lambda: asyncio.run(TorchEngine.import_blocks(rank, [1], None))):
        with pytest.raises(ValueError, match=QUEUE):
            entry()


def test_the_workers_step_floor_prices_one_rank():
    """At tp = 2 the drift detector's floor (engine/__main__.step_predictor)
    prices one rank: its local config's heads and kv heads' pages and its
    weight shard, the reference's predict_step_seconds at those values."""
    from dynamo_tpu_torch.engine.__main__ import step_predictor
    from dynamo_tpu_torch.engine.telemetry import StepStats
    from dynamo_tpu_torch.parallel.mesh import local_config

    m = LlamaConfig(**TINY)
    shard = {"w": torch.zeros(500, dtype=torch.bfloat16)}
    rank = types.SimpleNamespace(mcfg=local_config(m, 2), params=shard,
                                 schedule={"rtt_s": 1e-4}, kv_quantized=False)
    stats = StepStats(phase="decode", duration_s=0.01, batch_occupancy=2, batch_size=4,
                      tokens=8, queue_depth=0, kv_active_blocks=10, kv_free_blocks=50,
                      kv_total_blocks=64)
    want = jcosts.predict_step_seconds(
        [(1, 20)] * 2, block_size=4, kv_heads=1, num_heads=2, head_dim=16, layers=2,
        hbm_bytes_s=3.35e12, dispatch_s=1e-4, weight_bytes=1000)
    assert step_predictor(rank, types.SimpleNamespace(block_size=4))(stats) == want
