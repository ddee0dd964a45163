"""The port's KV transfer (engine/transfer.py) against the reference's, on
the CPU.

- The wire in both directions, in one process: a port KvTransferServer
  answers the reference's KvTransferClient, and the reference's server the
  port's client, blocking and streamed, on bf16 and int8 caches. The pages
  each importer holds afterwards are bit-equal to its source's, and the
  port server's ``data`` / ``scales`` bytes are the reference's formula
  (``np.stack`` of every layer's ``cache[ids]``) applied to its caches.
- The protocol's edges, mirroring the reference's
  tests/test_streamed_transfer.py: the commit signal's broadcast and
  generation, the bandwidth estimator's priors and EWMA (the EWMA held to
  the reference's on the same observations), a cancelled stream releasing
  its window leases, a clean stream keeping them for the client's
  ``free_pull``, a stream on a full arena waiting for the client's frees,
  and a lease past its expiry reclaimed and counted (the
  device plane's staging arena stubbed by a CPU buffer, as the reference's
  tests stub the native agent's).
- The in-process mover (the reference's tests/test_ici_transfer.py):
  bit-equal to the inline wire; a destination without room imports
  nothing, which is counted, and a second pull with room imports all.
- Faults: ``transfer.pull:drop@1`` makes the client retry and import
  everything; a drop on every attempt ends in the local recompute, with
  the same greedy stream and the recompute counter at 1.
- The ``wire_collapse`` detector fed by real pulls: slow pulls (a seeded
  delay fault) after fast ones collapse the wire's EWMA and trip it.
- The page-copy wrappers' wire-order plain versions: the layer-major
  gather and scatter equal the block-major ones, permuted.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu.runtime import bandwidth as jbandwidth
from dynamo_tpu_torch.engine import transfer as ttransfer
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import block_copy as bc
from dynamo_tpu_torch.ops.quant import QuantizedKV
from dynamo_tpu_torch.runtime import Context
from dynamo_tpu_torch.runtime import bandwidth as tbandwidth
from dynamo_tpu_torch.runtime import health as thealth
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.tokens import compute_sequence_hashes
from dynamo_tpu_torch.transfer import native_available
from torch_feature_engines import collect, request, tokens
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=128)
BS = 4
ENGINE = dict(num_blocks=64, block_size=BS, max_batch_size=4, max_context=128,
              prefill_buckets=(16, 32), seed=0, decode_steps=1, decode_pipeline=1)
PROMPT = tokens(11, 96, 256)   # 24 blocks, three 32-token chunks
HASHES = [int(h) for h in compute_sequence_hashes(PROMPT, BS)]


@pytest.fixture(autouse=True)
def _wire_only(monkeypatch):
    """Engines of one process would take the in-process mover; these tests
    hold the wire unless they say otherwise. The reference's device path
    needs its PJRT transfer server: off."""
    monkeypatch.setenv("DTPU_ICI_TRANSFER", "0")
    monkeypatch.setenv("DTPU_DEVICE_TRANSFER", "0")
    FAULTS.disarm()
    yield
    FAULTS.disarm()


class Pair:
    """One tiny llama's weights in both packages at ``dtype``."""

    def __init__(self, dtype: str):
        jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                    "f32": (jnp.float32, torch.float32)}[dtype]
        self.jcfg = jllama.LlamaConfig(dtype=jdt, **MODEL)
        self.tcfg = tllama.LlamaConfig(dtype=tdt, **MODEL)
        f32 = jllama.init_params(jax.random.PRNGKey(5),
                                 jllama.LlamaConfig(dtype=jnp.float32, **MODEL))
        self.tree = jax.tree.map(np.asarray, f32)
        self.jparams = jax.tree.map(lambda x: jnp.asarray(x, jdt), f32)

    def jax_engine(self, kv: str) -> TpuEngine:
        cfg = TpuEngineConfig(model=self.jcfg, use_pallas=False, kv_dtype=kv,
                              **{k: v for k, v in ENGINE.items() if k != "seed"})
        return TpuEngine(cfg, params=self.jparams,
                         mesh=make_mesh(tp=1, devices=jax.devices()[:1]))

    def torch_engine(self, kv: str, **kw) -> TorchEngine:
        cfg = TorchEngineConfig(model=self.tcfg, device="cpu", kv_dtype=kv, **{**ENGINE, **kw})
        return TorchEngine(cfg, params=params_from_numpy(self.tree, self.tcfg, device="cpu"))


def port_pages(engine: TorchEngine, hashes) -> bytes:
    """The bytes of every layer's K and V pages (and scale rows) of
    ``hashes`` in the port's engine, [n, L, 2, ...] order."""
    ids = engine.allocator.acquire_prefix(hashes)
    assert len(ids) == len(hashes)
    try:
        got = bc.gather_layers_ref(engine.k_caches, engine.v_caches,
                                   torch.tensor(ids, dtype=torch.int32))
        parts = [got.data, got.scale] if isinstance(got, QuantizedKV) else [got]
        return b"".join((p.view(torch.int16) if p.dtype == torch.bfloat16 else p)
                        .numpy().tobytes() for p in parts)
    finally:
        engine.allocator.release(ids)


def ref_pages(engine: TpuEngine, hashes) -> bytes:
    """The same bytes from the reference's engine."""
    ids = engine.allocator.acquire_prefix(hashes)
    assert len(ids) == len(hashes)
    try:
        idx = np.asarray(ids)
        if engine.kv_quantized:
            pay = np.stack([np.stack([np.asarray(k.data[idx]), np.asarray(v.data[idx])])
                            for k, v in zip(engine.k_caches, engine.v_caches)])
            scl = np.stack([np.stack([np.asarray(k.scale[idx]), np.asarray(v.scale[idx])])
                            for k, v in zip(engine.k_caches, engine.v_caches)])
            return (np.ascontiguousarray(np.moveaxis(pay, 2, 0)).tobytes()
                    + np.ascontiguousarray(np.moveaxis(scl, 2, 0)).tobytes())
        arr = np.stack([np.stack([np.asarray(k[idx]), np.asarray(v[idx])])
                        for k, v in zip(engine.k_caches, engine.v_caches)])
        return np.ascontiguousarray(np.moveaxis(arr, 2, 0)).view(np.uint8).tobytes()
    finally:
        engine.allocator.release(ids)


async def _prefill(engine, prompt=PROMPT):
    jax_side = isinstance(engine, TpuEngine)
    req = request(jax_side, "prefill", prompt, 1)
    ctx = JContext() if jax_side else Context()
    async for _ in engine.generate(req, ctx):
        pass


@pytest.fixture(scope="module", params=["bf16", "int8"])
def pair(request):
    return request.param, Pair("bf16")


@pytest.mark.parametrize("stream", [False, True], ids=["blocking", "streamed"])
def test_a_port_server_answers_the_reference_client(pair, stream):
    kv_name, weights = pair
    kv = "int8" if kv_name == "int8" else "model"

    async def main():
        src = weights.torch_engine(kv)
        dst = weights.jax_engine(kv)
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            got = await dst._get_transfer_client().fetch_and_import(
                addr, HASHES, stream=stream)
            assert got == len(HASHES) * BS
            assert ref_pages(dst, HASHES) == port_pages(src, HASHES)
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())


@pytest.mark.parametrize("stream", [False, True], ids=["blocking", "streamed"])
def test_the_reference_server_answers_a_port_client(pair, stream):
    kv_name, weights = pair
    kv = "int8" if kv_name == "int8" else "model"

    async def main():
        src = weights.jax_engine(kv)
        dst = weights.torch_engine(kv)
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            got = await dst._get_transfer_client().fetch_and_import(
                addr, HASHES, stream=stream)
            assert got == len(HASHES) * BS
            assert port_pages(dst, HASHES) == ref_pages(src, HASHES)
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())


def test_the_inline_items_bytes_are_the_reference_formula(pair):
    """The port server's blocking frame: shape [L, 2, n, bs, kvh, d], the
    reference's dtype name, and ``data`` (and int8 ``scales``) equal to
    ``np.stack`` of each layer's ``np.stack([k[ids], v[ids]])`` over the
    port's caches, as the reference's server builds it."""
    kv_name, weights = pair
    kv = "int8" if kv_name == "int8" else "model"

    async def main():
        src = weights.torch_engine(kv)
        try:
            await _prefill(src)
            await src.serve_transfer()
            frames = [it async for it in src._kv_transfer_srv.handle({"hashes": HASHES}, None)]
            ids = src.allocator.match_prefix(HASHES)
            return src, frames, ids
        finally:
            src.stop()

    src, frames, ids = asyncio.run(main())
    (frame,) = frames
    n = len(HASHES)
    assert frame["matched"] == n
    assert frame["shape"] == [MODEL["num_layers"], 2, n, BS, MODEL["num_kv_heads"],
                             MODEL["head_dim"]]
    idx = torch.tensor(ids)
    if kv == "int8":
        assert frame["dtype"] == "int8"
        pay = np.stack([np.stack([k.data[idx].numpy(), v.data[idx].numpy()])
                        for k, v in zip(src.k_caches, src.v_caches)])
        scl = np.stack([np.stack([k.scale[idx].numpy(), v.scale[idx].numpy()])
                        for k, v in zip(src.k_caches, src.v_caches)])
        assert frame["data"] == pay.tobytes() and frame["scales"] == scl.tobytes()
    else:
        assert frame["dtype"] == "bfloat16" and "scales" not in frame
        arr = np.stack([np.stack([k[idx].view(torch.int16).numpy(),
                                  v[idx].view(torch.int16).numpy()])
                        for k, v in zip(src.k_caches, src.v_caches)])
        assert frame["data"] == arr.tobytes()


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_the_wire_order_page_moves_are_the_stacked_ones_permuted(quantized):
    """gather_layers_wire / scatter_layers_wire (plain versions on the CPU)
    against gather_layers / scatter_layers: the same pages, [L, 2, n, ...]
    for [n, L, 2, ...], and into a given buffer too."""
    gen = torch.Generator().manual_seed(3)
    L, nb, kvh, d = 3, 12, 2, 8

    def cache():
        x = torch.randn((nb, BS, kvh, d), generator=gen).to(torch.bfloat16)
        if not quantized:
            return x
        return QuantizedKV(torch.randint(-127, 128, (nb, BS, kvh, d), dtype=torch.int8,
                                         generator=gen), torch.rand((nb, kvh), generator=gen))

    ks, vs = [cache() for _ in range(L)], [cache() for _ in range(L)]
    ids = torch.tensor([7, 2, 9, 4], dtype=torch.int32)
    wire = bc.gather_layers_wire(ks, vs, ids)
    stacked = bc.gather_layers(ks, vs, ids)
    parts = [(wire.data, stacked.data), (wire.scale, stacked.scale)] if quantized else [
        (wire, stacked)]
    for w, s in parts:
        assert w.shape[:3] == (L, 2, 4) and torch.equal(w, s.permute(1, 2, 0, *range(3, s.dim())))
    out = bc.gather_layers_wire(ks, vs, ids, out=(
        QuantizedKV(torch.zeros_like(wire.data), torch.zeros_like(wire.scale)) if quantized
        else torch.zeros_like(wire)))
    for w, o in ([(wire.data, out.data), (wire.scale, out.scale)] if quantized
                 else [(wire, out)]):
        assert torch.equal(w, o)
    ks2, vs2 = [cache() for _ in range(L)], [cache() for _ in range(L)]
    dst = torch.tensor([0, 5, 11, 3], dtype=torch.int32)
    bc.scatter_layers_wire(ks2, vs2, dst, wire)
    back = bc.gather_layers(ks2, vs2, dst)
    for a, b in ([(back.data, stacked.data), (back.scale, stacked.scale)] if quantized
                 else [(back, stacked)]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("src_kv,dst_kv", [("model", "int8"), ("int8", "model")])
def test_a_pull_across_cache_formats_imports_as_the_reference(src_kv, dst_kv):
    """Float pages at an int8 cache quantize on import, int8 pages at a
    float cache dequantize, as the reference's import does: a port engine
    and a reference engine pulling from one port server hold the same
    pages afterwards."""
    weights = Pair("bf16")

    async def main():
        src = weights.torch_engine(src_kv)
        port_dst, ref_dst = weights.torch_engine(dst_kv), weights.jax_engine(dst_kv)
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            for dst in (port_dst, ref_dst):
                got = await dst._get_transfer_client().fetch_and_import(addr, HASHES)
                assert got == len(HASHES) * BS
            assert port_pages(port_dst, HASHES) == ref_pages(ref_dst, HASHES)
        finally:
            for e in (src, port_dst, ref_dst):
                e.stop()

    asyncio.run(main())


# ----------------------------------------------------------- protocol edges
async def test_commit_signal_broadcast_and_generation():
    sig = ttransfer.KvCommitSignal()
    g0 = sig.gen
    sig.fire()
    assert await sig.wait(g0, timeout=0.01) == g0 + 1   # a fire between waits is kept
    g = sig.gen
    r1 = asyncio.create_task(sig.wait(g, timeout=5.0))
    r2 = asyncio.create_task(sig.wait(g, timeout=5.0))
    await asyncio.sleep(0.01)
    sig.fire()
    assert await r1 == g + 1 and await r2 == g + 1        # one fire wakes both
    assert await sig.wait(sig.gen, timeout=0.01) == sig.gen


def test_bandwidth_estimator_priors_and_ewma():
    est = tbandwidth.WireBandwidthEstimator(alpha=0.5)
    ref = jbandwidth.WireBandwidthEstimator(alpha=0.5)
    # unseen wires price at their prior; unknown classes at the default's
    assert est.bandwidth("device") == tbandwidth.WIRE_PRIORS["device"]
    assert est.bandwidth("carrier-pigeon") == tbandwidth.WIRE_PRIORS["inline"]
    assert est.transfer_seconds("native", 0) == 0.0
    # the host classes keep the reference's priors; the device classes are
    # the H100's (half its HBM rate: each byte read and written once)
    for w in ("native", "inline"):
        assert tbandwidth.WIRE_PRIORS[w] == jbandwidth.WIRE_PRIORS[w]
    assert tbandwidth.WIRE_PRIORS["ici"] == tbandwidth.WIRE_PRIORS["device"] == 3.35e12 / 2
    obs = [("native", 10_000_000, 0.01), ("native", 10_000_000, 0.02), ("native", 0, 1.0),
           ("native", 100, 0.0), ("inline", 5_000, 0.5), ("inline", 9_000, 0.1)]
    for w, b, s in obs:
        est.observe(w, b, s)
        ref.observe(w, b, s)
    assert est.bandwidth("native") == pytest.approx(0.5 * 1e9 + 0.5 * 5e8)
    for w in ("native", "inline"):
        assert est.bandwidth(w) == ref.bandwidth(w)
        assert est.snapshot()[w]["observations"] == ref.snapshot()[w]["observations"]
    assert est.snapshot()["native"]["observations"] == 2   # degenerate samples ignored
    assert est.transfer_seconds("native", 7.5e8) == pytest.approx(1.0)


class _StubArena:
    """The staging arena as a CPU buffer (no CUDA IPC here)."""

    def __init__(self, nbytes):
        self.buf = torch.zeros(nbytes, dtype=torch.uint8)
        self.nbytes = nbytes
        self.handle = b"\0" * 64

    def view(self, offset, dtype, shape):
        n = int(np.prod(shape)) * torch.empty((), dtype=dtype).element_size()
        return self.buf[offset:offset + n].view(dtype).view(*shape)

    def close(self):
        pass


async def _device_stream_server():
    """A transfer server whose device plane is a stub arena: its real lease
    table, no CUDA. 24 committed blocks."""
    eng = Pair("bf16").torch_engine("model")
    await eng.serve_transfer()
    srv = eng._kv_transfer_srv
    srv._arena = _StubArena(srv._arena_slots * srv._block_nbytes)
    srv._card = "stub"
    await _prefill(eng)
    return eng, srv


async def test_a_cancelled_stream_releases_its_window_leases():
    eng, srv = await _device_stream_server()
    try:
        gen = srv._handle_stream({"hashes": HASHES, "stream": True, "window": 8,
                                  "device_ok": True})
        frame = await gen.__anext__()            # the first window: 8 slots leased
        assert "device" in frame and len(frame["device"]["ipc"]["slots"]) == 8
        assert len(srv._slot_lease) == 8 and len(srv._pull_pending) == 1
        # the window's bytes in the arena are the pages, wire order
        want = bc.gather_layers_wire(eng.k_caches, eng.v_caches, torch.tensor(
            eng.allocator.match_prefix(HASHES[:8]), dtype=torch.int32))
        L, n, bs, kvh, d = frame["device"]["shape"]
        got = srv._arena.view(frame["device"]["ipc"]["offset"], torch.bfloat16,
                              (L, 2, n, bs, kvh, d))
        assert torch.equal(got, want)
        await gen.aclose()                      # the client is gone mid-stream
        assert not srv._slot_lease and not srv._pull_pending
    finally:
        eng.stop()


async def test_a_clean_stream_keeps_its_leases_for_the_clients_free():
    eng, srv = await _device_stream_server()
    try:
        frames = [it async for it in srv._handle_stream(
            {"hashes": HASHES, "stream": True, "window": 8, "device_ok": True})]
        assert frames[-1].get("eof") and frames[-1]["served"] == len(HASHES)
        windows = [it for it in frames if "device" in it]
        assert len(windows) == 3                # 24 blocks / window 8
        assert len(srv._slot_lease) == 24       # the client may still be reading
        for it in windows:
            out = [r async for r in srv.handle({"free_pull": it["device"]["uuid"]}, None)]
            assert out == [{"ok": True}]
        assert not srv._slot_lease and not srv._pull_pending
    finally:
        eng.stop()


async def test_a_stream_waits_for_its_clients_frees_when_the_arena_is_full():
    """A stream serves ahead of its client; with the arena full its next
    window waits for the client's ``free_pull`` and goes out as a device
    offer, not inline (the port's backpressure: a full arena is not a
    reason to fall back to the wire while frees are coming)."""
    eng, srv = await _device_stream_server()
    try:
        srv._arena_slots = 16                       # two 8-block windows
        srv._arena = _StubArena(16 * srv._block_nbytes)
        gen = srv._handle_stream({"hashes": HASHES, "stream": True, "window": 8,
                                  "device_ok": True})
        first = await gen.__anext__()
        second = await gen.__anext__()
        assert "device" in first and "device" in second
        third = asyncio.ensure_future(gen.__anext__())
        await asyncio.sleep(0.05)
        assert not third.done()                     # waiting for room
        assert [r async for r in srv.handle({"free_pull": first["device"]["uuid"]}, None)
                ] == [{"ok": True}]
        frame = await asyncio.wait_for(third, 5.0)
        assert "device" in frame and frame["offset"] == 16
        assert frame["device"]["ipc"]["slots"] == first["device"]["ipc"]["slots"]
        await gen.aclose()
    finally:
        eng.stop()


async def test_an_offer_past_its_lease_is_reclaimed_and_counted(monkeypatch):
    eng, srv = await _device_stream_server()
    try:
        frames = [it async for it in srv.handle({"hashes": HASHES[:8], "device_ok": True},
                                               None)]
        assert "device" in frames[0] and len(srv._slot_lease) == 8
        now = ttransfer.time.monotonic()
        monkeypatch.setattr(ttransfer.time, "monotonic",
                            lambda: now + ttransfer.SLOT_LEASE_S + 1.0)
        # the next offer's scan reclaims the expired one before it leases
        frames = [it async for it in srv.handle({"hashes": HASHES[8:16], "device_ok": True},
                                               None)]
        assert "device" in frames[0]
        assert srv._pull_leaked == 1
        assert set(srv._pull_pending) == {frames[0]["device"]["uuid"]}
        assert len(srv._slot_lease) == 8 and srv.snapshot()["leaked_offers"] == 1
        # past the leak budget the server offers the wire only
        srv._pull_leaked = ttransfer._DEVICE_LEAK_BUDGET
        frames = [it async for it in srv.handle({"hashes": HASHES[16:], "device_ok": True},
                                               None)]
        assert "device" not in frames[0] and frames[0]["matched"] == 8
    finally:
        eng.stop()


# ------------------------------------------------------- the in-process mover
def _stats():
    return dict(ttransfer.transfer_stats.counts)


@pytest.mark.parametrize("kv", ["model", "int8"])
def test_the_local_mover_is_bit_equal_to_the_wire(monkeypatch, kv):
    weights = Pair("bf16")

    async def main():
        src, via_mover, via_wire = (weights.torch_engine(kv) for _ in range(3))
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            assert addr in ttransfer.LOCAL_SERVERS
            monkeypatch.setenv("DTPU_ICI_TRANSFER", "1")
            client = via_mover._get_transfer_client()
            assert await client.fetch_and_import(addr, HASHES) == len(HASHES) * BS
            assert client.pulls[-1]["wire"] == "ici"
            monkeypatch.setenv("DTPU_ICI_TRANSFER", "0")
            client = via_wire._get_transfer_client()
            assert await client.fetch_and_import(addr, HASHES) == len(HASHES) * BS
            # between two port engines the wire is the native agent's
            # (inline where its library could not be built)
            assert client.pulls[-1]["wire"] == ("native" if native_available() else "inline")
            assert port_pages(via_mover, HASHES) == port_pages(src, HASHES)
            assert port_pages(via_wire, HASHES) == port_pages(src, HASHES)
        finally:
            for e in (src, via_mover, via_wire):
                e.stop()
        assert addr not in ttransfer.LOCAL_SERVERS   # stop() deregisters

    asyncio.run(main())


def test_the_local_mover_imports_nothing_into_a_full_destination(monkeypatch):
    monkeypatch.setenv("DTPU_ICI_TRANSFER", "1")
    weights = Pair("bf16")

    async def main():
        src, dst = weights.torch_engine("model"), weights.torch_engine("model")
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            hog = dst.allocator.allocate(dst.allocator.free_blocks)
            before = _stats()
            assert await dst._get_transfer_client().fetch_and_import(addr, HASHES) == 0
            assert _stats()["recompute"] == before["recompute"] + 1
            dst.allocator.release(hog)
            got = await dst._get_transfer_client().fetch_and_import(addr, HASHES)
            assert got == len(HASHES) * BS
            assert _stats()["recompute"] == before["recompute"] + 1
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())


# -------------------------------------------------------------------- faults
def test_a_dropped_pull_retries_and_imports_everything():
    weights = Pair("bf16")

    async def main():
        src, dst = weights.torch_engine("model"), weights.torch_engine("model")
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            FAULTS.arm("transfer.pull:drop@1")
            got = await dst._get_transfer_client().fetch_and_import(addr, HASHES)
            assert got == len(HASHES) * BS
            assert [f for f in FAULTS.fired if f[0] == "transfer.pull"] == [
                ("transfer.pull", "drop", 1)]
            assert port_pages(dst, HASHES) == port_pages(src, HASHES)
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())


def test_a_drop_on_every_attempt_ends_in_the_recompute():
    weights = Pair("f32")

    async def main():
        src, dst, agg = (weights.torch_engine("model") for _ in range(3))
        try:
            gold = await collect(agg, request(False, "gold", PROMPT, 8))
            await _prefill(src)
            addr = await src.serve_transfer()
            FAULTS.arm("transfer.pull:drop@1+")
            before = _stats()
            req = request(False, "d", PROMPT, 8)
            req.kv_transfer = {"address": addr, "hashes": HASHES}
            got = await collect(dst, req)
            assert got["tokens"] == gold["tokens"]
            assert got["cached"] == 0
            assert _stats()["recompute"] == before["recompute"] + 1
            from dynamo_tpu_torch.runtime.flight_recorder import get_flight_recorder

            kinds = [e["event"]["kind"] for e in get_flight_recorder().timeline("d")["events"]]
            assert "fetch_aborted" in kinds and "transfer_fallback" in kinds
        finally:
            for e in (src, dst, agg):
                e.stop()

    asyncio.run(main())


def test_collapsed_pulls_trip_the_wire_collapse_detector(monkeypatch):
    """Fast pulls (over the native agent, or inline without its library)
    arm the detector's reference; pulls slowed by a delay fault collapse
    the wire's EWMA under its collapse fraction."""
    monitor = thealth.HealthMonitor(min_interval_s=0.0)
    monkeypatch.setattr(thealth, "get_health_monitor", lambda: monitor)
    monkeypatch.setattr(tbandwidth, "_estimator", tbandwidth.WireBandwidthEstimator())
    events = []
    monitor.subscribe(events.append)
    weights = Pair("bf16")

    async def main():
        src = weights.torch_engine("model")
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            for i in range(14):
                dst = weights.torch_engine("model")
                await dst._get_transfer_client().fetch_and_import(addr, HASHES)
                dst.stop()
            assert not [e for e in events if e.detector == "wire_collapse"]
            FAULTS.arm("transfer.pull:delay=0.2")
            for i in range(10):
                dst = weights.torch_engine("model")
                await dst._get_transfer_client().fetch_and_import(addr, HASHES)
                dst.stop()
        finally:
            src.stop()

    asyncio.run(main())
    tripped = [e for e in events if e.detector == "wire_collapse"]
    wire = "native" if native_available() else "inline"
    assert tripped and tripped[0].subject == f"wire/{wire}" and tripped[0].ratio <= 0.3


class _FakeIpcLib:
    """dtt_ipc_open / dtt_ipc_close of ops/cuda_ipc, counted on the host."""

    def __init__(self):
        self.open, self.closed = {}, []

    def dtt_ipc_open(self, index, handle, out):
        out._obj.value = 0x1000 * (len(self.open) + len(self.closed) + 1)
        self.open[out._obj.value] = handle
        return 0

    def dtt_ipc_close(self, index, ptr):
        self.closed.append(self.open.pop(ptr.value))
        return 0


def test_ipc_mappings_close_when_replaced_failed_or_evicted(monkeypatch):
    """A client keeps one mapping per handle while it is in use or among
    the MAX_OPEN_ARENAS most recent; a server address offering a new handle
    closes the old one once its last pull releases it, and a failed pull
    retires its mapping."""
    from dynamo_tpu_torch.ops import cuda_ipc

    lib = _FakeIpcLib()
    monkeypatch.setattr(cuda_ipc, "_lib", lambda: lib)
    monkeypatch.setattr(cuda_ipc, "_opened", cuda_ipc.OrderedDict())
    monkeypatch.setattr(cuda_ipc, "_retired", {})
    monkeypatch.setattr(cuda_ipc, "_by_address", {})
    cpu = torch.device("cpu")
    a = cuda_ipc.open_arena(b"h1", cpu, "srv:1")
    assert cuda_ipc.open_arena(b"h1", cpu, "srv:1") == a and len(lib.open) == 1
    cuda_ipc.release_arena(b"h1")
    # the server restarts on its address: h1 closes when its last pull ends
    cuda_ipc.open_arena(b"h2", cpu, "srv:1")
    assert lib.closed == [] and cuda_ipc.open_arenas() == 2
    cuda_ipc.release_arena(b"h1")
    assert lib.closed == [b"h1"]
    cuda_ipc.release_arena(b"h2")
    assert cuda_ipc.open_arenas() == 1
    # a failed pull retires its mapping; the next offer opens it anew
    cuda_ipc.open_arena(b"h2", cpu, "srv:1")
    cuda_ipc.release_arena(b"h2", failed=True)
    assert lib.closed == [b"h1", b"h2"] and cuda_ipc.open_arenas() == 0
    # the least recently used idle mappings go past the bound
    n = cuda_ipc.MAX_OPEN_ARENAS
    busy = cuda_ipc.open_arena(b"busy", cpu, "srv:busy")
    for i in range(n + 2):
        cuda_ipc.open_arena(b"x%d" % i, cpu, f"srv:{i}")
        cuda_ipc.release_arena(b"x%d" % i)
    assert cuda_ipc.open_arenas() == n and b"busy" not in lib.closed
    assert lib.closed[2:] == [b"x0", b"x1", b"x2"]
    assert cuda_ipc.open_arena(b"busy", cpu, "srv:busy") == busy
