"""The port's native transfer agent (dynamo_tpu_torch/csrc/transfer_agent.cpp,
transfer/native.py) and the native branches of its KV transfer plane,
against the reference's on the CPU.

- The reference's seven agent cases (tests/test_native_transfer.py), as
  cases of one test, on the port's agent, built with g++ from the port's
  own source.
- The wire across packages: the port's ``native_fetch`` reading the
  reference's agent, and the reference's reading the port's, give the
  same bytes.
- The transfer plane across packages: a port server on
  ``TorchEngine(device="cpu")`` serves a JAX ``TpuEngine`` client over the
  native wire, and a reference server a port client, one-shot and
  streamed, on bf16 and int8 caches: the importer's pages equal the
  source's, bit for bit.
- A torn slot (the arena rewritten after its crc32 was taken) fails the
  client's check: nothing is imported and one recompute fallback is
  counted. A library that fails to build is logged at ERROR and the
  server answers inline, counting the fallback.
"""

import asyncio
import logging
import shutil
import threading
import zlib

import numpy as np
import pytest
import torch

from dynamo_tpu.transfer import native as jnative
from dynamo_tpu_torch.engine import transfer as ttransfer
from dynamo_tpu_torch.transfer import native as tnative
from test_torch_transfer import BS, HASHES, Pair, _prefill, port_pages, ref_pages
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, live by its name in this module

pytestmark = pytest.mark.skipif(shutil.which("g++") is None,
                                reason="no g++ to build the agent")


@pytest.fixture(autouse=True)
def _wire_only(monkeypatch):
    """Engines of one process would take the in-process mover, and the
    reference's device path needs its PJRT server: the wire only."""
    monkeypatch.setenv("DTPU_ICI_TRANSFER", "0")
    monkeypatch.setenv("DTPU_DEVICE_TRANSFER", "0")


@pytest.fixture(scope="module")
def both_built():
    """Both packages' agent libraries, built and loaded (after the build the
    reference's ``native_available`` may have started in the background)."""
    assert tnative.ensure_native()
    if jnative._build_thread is not None:
        jnative._build_thread.join(120)
    assert jnative.ensure_native()


# ------------------------------------------------------ the reference's cases
def _roundtrip_gather(agent):
    block_bytes = 4096
    arena = np.arange(64 * block_bytes, dtype=np.uint8).reshape(64, block_bytes)
    agent.register(7, arena, block_bytes)
    got = tnative.native_fetch("127.0.0.1", agent.port, 7, [3, 60, 0], block_bytes)
    np.testing.assert_array_equal(got, arena[[3, 60, 0]])


def _large_payload(agent):
    # a KV page batch: 32 blocks x 256 KiB = 8 MiB
    block_bytes = 256 * 1024
    arena = np.random.default_rng(0).integers(0, 256, size=(32, block_bytes), dtype=np.uint8)
    agent.register(1, arena, block_bytes)
    got = tnative.native_fetch("127.0.0.1", agent.port, 1, list(range(32)), block_bytes)
    np.testing.assert_array_equal(got, arena)


def _unknown_region_fails(agent):
    with pytest.raises(RuntimeError):
        tnative.native_fetch("127.0.0.1", agent.port, 999, [0], 64)


def _out_of_range_block_fails(agent):
    agent.register(2, np.zeros((4, 64), np.uint8), 64)
    with pytest.raises(RuntimeError):
        tnative.native_fetch("127.0.0.1", agent.port, 2, [4], 64)


def _unregister(agent):
    agent.register(3, np.zeros((4, 64), np.uint8), 64)
    agent.unregister(3)
    with pytest.raises(RuntimeError):
        tnative.native_fetch("127.0.0.1", agent.port, 3, [0], 64)


def _concurrent_fetches(agent):
    block_bytes = 64 * 1024
    arena = np.random.default_rng(1).integers(0, 256, size=(16, block_bytes), dtype=np.uint8)
    agent.register(4, arena, block_bytes)
    errors = []

    def worker(seed):
        rng = np.random.default_rng(seed)
        for _ in range(5):
            ids = rng.choice(16, size=8, replace=False)
            got = tnative.native_fetch("127.0.0.1", agent.port, 4, list(ids), block_bytes)
            if not np.array_equal(got, arena[ids]):
                errors.append(seed)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not errors and not any(t.is_alive() for t in threads)


def _connection_refused(agent):
    with pytest.raises(RuntimeError):
        tnative.native_fetch("127.0.0.1", 1, 0, [0], 64)


AGENT_CASES = {f.__name__[1:]: f for f in (
    _roundtrip_gather, _large_payload, _unknown_region_fails, _out_of_range_block_fails,
    _unregister, _concurrent_fetches, _connection_refused)}


@pytest.mark.parametrize("case", sorted(AGENT_CASES))
def test_the_reference_agent_cases_on_the_ports_agent(case):
    agent = tnative.NativeAgent(host="127.0.0.1")
    try:
        AGENT_CASES[case](agent)
    finally:
        agent.close()


@pytest.mark.parametrize("server", ["port", "reference"])
def test_each_packages_fetch_reads_the_others_agent(both_built, server):
    """The wire is the reference's byte for byte: each side's client reads
    the other's agent, into a numpy array or (the port's) a pinned-style
    host tensor, and gets the arena's blocks."""
    block_bytes = 3 * 4096 + 8
    arena = np.random.default_rng(2).integers(0, 256, size=(12, block_bytes), dtype=np.uint8)
    agent = (tnative if server == "port" else jnative).NativeAgent(host="127.0.0.1")
    client = jnative if server == "port" else tnative
    try:
        agent.register(5, arena, block_bytes)
        ids = [11, 0, 7, 7, 3]
        got = client.native_fetch("127.0.0.1", agent.port, 5, ids, block_bytes)
        np.testing.assert_array_equal(got, arena[ids])
        out = torch.zeros(len(ids) * block_bytes, dtype=torch.uint8)
        tnative.native_fetch("127.0.0.1", agent.port, 5, ids, block_bytes, out=out)
        assert np.array_equal(out.view(len(ids), block_bytes).numpy(), arena[ids])
    finally:
        agent.close()


def test_the_ports_agent_takes_a_host_tensor_arena():
    """The serving arena is a uint8 host tensor (pinned on the card): its
    data pointer is registered and the tensor kept alive by the agent."""
    arena = torch.arange(8 * 512, dtype=torch.int32).to(torch.uint8)
    agent = tnative.NativeAgent(host="127.0.0.1")
    try:
        agent.register(1, arena, 512)
        got = tnative.native_fetch("127.0.0.1", agent.port, 1, [6, 2], 512)
        assert np.array_equal(got, arena.view(8, 512).numpy()[[6, 2]])
        with pytest.raises(ValueError):
            agent.register(2, arena[::2], 256)   # not contiguous
        with pytest.raises(ValueError):
            agent.register(3, arena, 500)        # not whole blocks
    finally:
        agent.close()


# ------------------------------------------------------ the transfer plane
@pytest.fixture(scope="module", params=["bf16", "int8"])
def pair(request):
    return request.param, Pair("bf16")


@pytest.mark.parametrize("stream", [False, True], ids=["one-shot", "streamed"])
def test_a_port_server_serves_the_reference_client_natively(both_built, pair, stream):
    kv = "int8" if pair[0] == "int8" else "model"

    async def main():
        src, dst = pair[1].torch_engine(kv), pair[1].jax_engine(kv)
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            got = await dst._get_transfer_client().fetch_and_import(addr, HASHES,
                                                                    stream=stream)
            assert got == len(HASHES) * BS
            native = src._kv_transfer_srv.snapshot()["native"]
            assert native["blocks"] == len(HASHES) and native["leased_slots"] == 0
            assert ref_pages(dst, HASHES) == port_pages(src, HASHES)
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())


@pytest.mark.parametrize("stream", [False, True], ids=["one-shot", "streamed"])
def test_the_reference_server_serves_a_port_client_natively(both_built, pair, stream):
    kv = "int8" if pair[0] == "int8" else "model"

    async def main():
        src, dst = pair[1].jax_engine(kv), pair[1].torch_engine(kv)
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            client = dst._get_transfer_client()
            got = await client.fetch_and_import(addr, HASHES, stream=stream)
            assert got == len(HASHES) * BS
            assert client.pulls[-1]["wire"] == "native"
            assert client.pulls[-1]["windows"] == (3 if stream else 0)   # window 8
            assert port_pages(dst, HASHES) == ref_pages(src, HASHES)
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())


def test_the_native_slots_hold_the_reference_arena_bytes(both_built, pair):
    """A port server's native item: the reference's fields, and slots whose
    bytes are the blocks' storage format (bf16 pages, or each int8 block's
    payload then scales), as the reference's ``_gather_into_arena`` fills
    them, with their crc32s."""
    kv = "int8" if pair[0] == "int8" else "model"

    async def main():
        src = pair[1].torch_engine(kv)
        try:
            await _prefill(src)
            await src.serve_transfer()
            srv = src._kv_transfer_srv
            (item,) = [it async for it in srv.handle({"hashes": HASHES, "native_ok": True},
                                                     None)]
            nat = item["native"]
            raw = tnative.native_fetch(nat["host"], nat["port"], nat["region"], nat["slots"],
                                       item["block_bytes"])
            return src, item, raw
        finally:
            src.stop()

    src, item, raw = asyncio.run(main())
    assert item["matched"] == len(HASHES)
    assert item["block_shape"] == [2, 2, BS, 2, 16]
    assert (item["dtype"], item["kv_dtype"]) == (
        ("uint8", "int8") if kv == "int8" else ("bfloat16", "model"))
    assert item["block_bytes"] == src.kv_bytes_per_block
    assert raw.tobytes() == port_pages_block_major(src)
    assert item["native"]["crc32"] == [zlib.crc32(r) for r in raw]


def port_pages_block_major(engine) -> bytes:
    """The engine's pages of HASHES, each block's bytes in turn in the
    storage format (the reference's block-major arena layout)."""
    flat = np.frombuffer(port_pages(engine, HASHES), np.uint8)
    n = len(HASHES)
    if not engine.kv_quantized:
        return flat.tobytes()
    pay_bytes = n * engine._codec.payload_nbytes
    pay = flat[:pay_bytes].reshape(n, -1)
    scl = flat[pay_bytes:].reshape(n, -1)
    return np.concatenate([pay, scl], axis=1).tobytes()


def test_a_torn_slot_fails_its_crc32_and_counts_one_fallback(both_built):
    """The arena rewritten after the gather took its crc32s (a lease that
    expired and was gathered again): the client reads torn bytes, imports
    nothing and recomputes, counted once."""
    weights = Pair("bf16")

    async def main():
        src, dst = weights.torch_engine("model"), weights.torch_engine("model")
        try:
            await _prefill(src)
            addr = await src.serve_transfer()
            srv = src._kv_transfer_srv
            gather = srv._gather_into_arena

            async def torn(block_ids, slot0):
                crcs = await gather(block_ids, slot0)
                srv._native_arena[slot0 * srv._block_nbytes + 5] ^= 0xFF
                return crcs

            srv._gather_into_arena = torn
            before = dict(ttransfer.transfer_stats.counts)
            got = await dst._get_transfer_client().fetch_and_import(addr, HASHES)
            assert got == 0
            assert dst.allocator.match_prefix(HASHES) == []
            assert (ttransfer.transfer_stats.counts["recompute"]
                    == before["recompute"] + 1)
            await asyncio.sleep(0.05)
            assert srv.snapshot()["native"]["leased_slots"] == 0   # the client freed them
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())


def test_a_failed_build_is_logged_and_the_plane_answers_inline(monkeypatch, caplog):
    """A compiler failure is an ERROR record with the compiler's output, the
    server answers inline, and the fallback is counted."""
    from dynamo_tpu_torch.ops import _build

    def broken(source):
        raise RuntimeError(f"g++ failed on {source} (exit 1):\nagent.cpp:1: error: boom")

    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_failed", False)
    monkeypatch.setattr(_build, "build_host", broken)
    weights = Pair("bf16")

    async def main():
        src, dst = weights.torch_engine("model"), weights.torch_engine("model")
        try:
            await _prefill(src)
            with caplog.at_level(logging.ERROR):
                addr = await src.serve_transfer()
            before = dict(ttransfer.transfer_stats.reasons)
            item = [it async for it in src._kv_transfer_srv.handle(
                {"hashes": HASHES, "native_ok": True}, None)][0]
            assert "native" not in item and item["matched"] == len(HASHES)
            reasons = ttransfer.transfer_stats.reasons
            assert reasons.get("native_to_inline:no_library", 0) == before.get(
                "native_to_inline:no_library", 0) + 1
            assert await dst._get_transfer_client().fetch_and_import(addr, HASHES) == (
                len(HASHES) * BS)
            assert dst._get_transfer_client().pulls[-1]["wire"] == "inline"
        finally:
            src.stop()
            dst.stop()

    asyncio.run(main())
    assert any(r.levelno == logging.ERROR and "boom" in r.getMessage()
               for r in caplog.records)
