"""The port's G4 remote block tier (kvbm/remote.py) and its write-through in
KvbmTiers (kvbm/pool.py) against the reference's, on the CPU.

- The wire both ways, in one process: the port's RemoteBlockPool against
  the reference's RemoteBlockStoreServer and the reference's client
  against the port's server. Float32, bf16 and int8 (flat codec buffer)
  blocks round-trip bit for bit; the port's frames are the reference's
  byte for byte (the ``!II`` header, the MessagePack header through the
  port's codec, the raw payload).
- The counterparts of the reference's tests/test_kvbm_remote.py: the LRU
  eviction, the disk payloads (the same file and bytes as the reference's
  server writes), an unreachable store degrading to a miss, the offload
  queue's priority order and shedding, and KvbmTiers with a remote tier:
  prefix matches extended by the remote, onboarding a block another
  worker's tiers wrote, promotion to G2.
"""

import asyncio
import threading

import ml_dtypes
import numpy as np
import pytest

from dynamo_tpu.kvbm import pool as jpool
from dynamo_tpu.kvbm import remote as jremote
from dynamo_tpu_torch.kvbm import pool as tpool
from dynamo_tpu_torch.kvbm import remote as tremote
from dynamo_tpu_torch.kvbm.layout import BF16_BITS

PKGS = {"port": tremote, "ref": jremote}
# (client, server): each package's client against the other's server, and
# the port against itself
WIRES = [("port", "ref"), ("ref", "port"), ("port", "port")]


def _block(seed: int, shape=(2, 2, 4, 2, 8)) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


class _ServerThread:
    """A store server on its own event loop, so that the blocking clients
    run on the test thread (as on an engine's offload thread)."""

    def __init__(self, pkg: str = "port", **kw):
        self.mod = PKGS[pkg]
        self.kw = kw
        self.address = None
        self._loop = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        assert self._started.wait(5.0)

    def _run(self):
        self._loop = asyncio.new_event_loop()
        asyncio.set_event_loop(self._loop)
        self.server = self.mod.RemoteBlockStoreServer(host="127.0.0.1", port=0, **self.kw)
        self.address = self._loop.run_until_complete(self.server.start())
        self._started.set()
        self._loop.run_forever()

    def stop(self):
        asyncio.run_coroutine_threadsafe(self.server.stop(), self._loop).result(5.0)
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5.0)


@pytest.fixture
def servers():
    made = []

    def make(pkg="port", **kw):
        s = _ServerThread(pkg, **{"capacity_bytes": 1 << 20, **kw})
        made.append(s)
        return s

    yield make
    for s in made:
        s.stop()


def _bf16_pair(seed: int):
    """One bf16 block in each package's host form: the reference's
    ml_dtypes array and the port's bit patterns."""
    ref = _block(seed).astype(ml_dtypes.bfloat16)
    return ref, ref.view(np.uint16).view(BF16_BITS)


def _int8_buf(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, 1152, dtype=np.uint8)


@pytest.mark.parametrize("client,server", WIRES, ids=lambda p: p)
def test_store_get_roundtrip_and_stats(servers, client, server):
    s = servers(server)
    pool = PKGS[client].RemoteBlockPool(s.address)
    b = _block(1)
    pool.store(0xABC, b)
    assert 0xABC in pool
    got = pool.get(0xABC)
    assert got.dtype == np.float32 and got.tobytes() == b.tobytes()
    assert pool.get(0xDEF) is None
    assert pool.contains_many([0xABC, 0xDEF]) == [True, False]
    st = pool.stats()
    assert st == {"blocks": 1, "bytes": b.nbytes, "hits": 1, "misses": 1}
    pool.close()


@pytest.mark.parametrize("client,server", WIRES, ids=lambda p: p)
def test_bf16_and_int8_blocks_cross_bit_exact(servers, client, server):
    """A bf16 block stored by one package's client and read by the other's
    keeps its bits and comes back as each package's bf16 form; an int8
    codec buffer comes back byte for byte."""
    s = servers(server)
    writer = PKGS[client].RemoteBlockPool(s.address)
    reader_pkg = "ref" if client == "port" else "port"
    reader = PKGS[reader_pkg].RemoteBlockPool(s.address)
    ref16, port16 = _bf16_pair(2)
    writer.store(1, port16 if client == "port" else ref16)
    writer.store(2, _int8_buf(3))
    got16 = reader.get(1)
    want = port16 if reader_pkg == "port" else ref16
    assert got16.dtype == want.dtype and got16.shape == want.shape
    assert got16.tobytes() == ref16.tobytes()
    got8 = reader.get(2)
    assert got8.dtype == np.uint8 and got8.tobytes() == _int8_buf(3).tobytes()
    writer.close()
    reader.close()


@pytest.mark.parametrize("obj,payload", [
    ({"op": "store", "hash": 0xFFFF_FFFF_FFFF_FFFF, "shape": [2, 2, 4, 2, 8],
      "dtype": "bfloat16"}, b"\x01\x02" * 64),
    ({"op": "has", "hashes": [1, 2**40, 2**63 + 5]}, b""),
    ({"ok": True, "shape": [1152], "dtype": "uint8"}, bytes(range(256))),
    ({"blocks": 3, "bytes": 6144, "hits": 0, "misses": 2}, b""),
], ids=["store", "has", "get-reply", "stats"])
def test_frames_are_the_references_byte_for_byte(obj, payload):
    assert tremote._pack(obj, payload) == jremote._pack(obj, payload)


def test_lru_eviction_keeps_the_newest(servers):
    s = servers("port", capacity_bytes=3 * _block(0).nbytes)
    pool = tremote.RemoteBlockPool(s.address)
    for i in range(5):
        pool.store(i, _block(i))
    have = pool.contains_many(list(range(5)))
    assert have == [False, False, True, True, True]
    # a get refreshes recency: 2 survives the next store, 3 goes
    assert pool.get(2) is not None
    pool.store(5, _block(5))
    assert pool.contains_many([2, 3, 4, 5]) == [True, False, True, True]
    pool.close()


def test_disk_payloads_are_the_references_files(servers, tmp_path):
    """With ``disk_path`` both servers keep the payload in
    ``<hash:016x>.kv`` with the same bytes, and serve it back from there."""
    b = _block(7)
    files = {}
    for pkg in ("port", "ref"):
        d = tmp_path / pkg
        s = servers(pkg, disk_path=str(d))
        pool = tremote.RemoteBlockPool(s.address)
        pool.store(0x77, b)
        assert pool.get(0x77).tobytes() == b.tobytes()
        files[pkg] = (d / "0000000000000077.kv").read_bytes()
        assert s.server._blocks[0x77][2] is None   # the index holds no payload
        pool.close()
    assert files["port"] == files["ref"] == b.tobytes()


@pytest.mark.parametrize("pkg", ["port", "ref"])
def test_unreachable_store_degrades_to_a_miss(pkg):
    pool = PKGS[pkg].RemoteBlockPool("127.0.0.1:1", timeout_s=0.2, max_failures=2)
    assert pool.get(1) is None
    assert 1 not in pool
    assert pool.disabled   # after max_failures, G4 turns itself off
    assert pool.get(2) is None and pool.contains_many([3, 4]) == [False, False]
    assert pool.stats() == {}
    pool.store(5, _block(5))   # a no-op, never a raise


@pytest.mark.parametrize("mod", [tpool, jpool], ids=["port", "ref"])
def test_offload_queue_priority_and_fifo(mod):
    q = mod.OffloadQueue(max_items=16)
    for h, prio in ((1, 1), (2, 0), (3, 1), (4, 0)):
        q.put(h, f"b{h}", priority=prio)
    assert [q.get()[2] for _ in range(4)] == [2, 4, 1, 3]


@pytest.mark.parametrize("mod", [tpool, jpool], ids=["port", "ref"])
def test_offload_queue_sheds_lowest_priority(mod):
    q = mod.OffloadQueue(max_items=2)
    q.put(1, "p", priority=0)
    q.put(2, "d", priority=5)
    q.put(3, "p2", priority=0)   # overflow: the priority-5 item is shed
    assert q.shed == 1
    assert {q.get()[2] for _ in range(2)} == {1, 3}


@pytest.mark.parametrize("server", ["port", "ref"])
def test_tiers_with_remote_prefix_and_priority(servers, server):
    """Write-through to the remote under a 2-block host tier: the prefix
    still matches and loads whole through the remote, and filter_servable
    asks the remote in one batch; the port's tiers report what the
    reference's report for the same offloads."""
    s = servers(server)
    bn = _block(0).nbytes
    blocks = {h: _block(h) for h in (10, 11, 12, 13)}
    results = []
    for pool_mod, remote_mod in ((tpool, tremote), (jpool, jremote)):
        tiers = pool_mod.KvbmTiers(bn, host_capacity_bytes=2 * bn,
                                   remote=remote_mod.RemoteBlockPool(s.address))
        for h in (12, 13):
            tiers.offload(h, blocks[h], priority=1)
        for h in (10, 11):
            tiers.offload(h, blocks[h], priority=0)
        tiers.flush()
        n = tiers.match_prefix([10, 11, 12, 13, 99])
        arr = tiers.load_prefix([10, 11, 12, 13])
        servable = sorted(tiers.filter_servable([10, 11, 12, 13, 99]))
        results.append((n, arr.tobytes(), servable))
        tiers.close()
        tiers.remote.close()
    assert results[0] == results[1]
    n, data, servable = results[0]
    assert n == 4 and servable == [10, 11, 12, 13]
    assert data == np.stack([blocks[h] for h in (10, 11, 12, 13)]).tobytes()


@pytest.mark.parametrize("producer,consumer", [("port", "ref"), ("ref", "port")])
def test_a_block_another_workers_tiers_wrote_onboards_here(servers, producer, consumer):
    """The G4 point, across packages: one package's tiers write a bf16
    block through; the other's match it, load it bit for bit and promote
    it into their host tier; the port's tiers list it as newly stored for
    the directory."""
    s = servers("port")
    mods = {"port": (tpool, tremote), "ref": (jpool, jremote)}
    bn = _block(0).nbytes // 2
    ref16, port16 = _bf16_pair(42)
    (pm, rm), (cm, crm) = mods[producer], mods[consumer]
    prod = pm.KvbmTiers(bn, host_capacity_bytes=4 * bn, remote=rm.RemoteBlockPool(s.address))
    cons = cm.KvbmTiers(bn, host_capacity_bytes=4 * bn, remote=crm.RemoteBlockPool(s.address))
    prod.store(0x4242, port16 if producer == "port" else ref16)
    assert 0x4242 not in cons and cons.match_prefix([0x4242, 0x4343]) == 1
    got = cons.load_prefix([0x4242])
    assert got.shape == (1,) + ref16.shape and got.tobytes() == ref16.tobytes()
    assert 0x4242 in cons.host and cons.tier_of(0x4242) == "g2"
    port_tiers = prod if producer == "port" else cons
    # the port's stored feed: a store, never a promotion
    assert port_tiers.drain_stored() == ([0x4242] if producer == "port" else [])
    for t in (prod, cons):
        t.close()
        t.remote.close()


def test_get_block_reads_local_tiers_without_promotion(tmp_path):
    """``get_block`` (the tier stream's read) names the tier and leaves the
    host LRU alone; ``tier_of`` agrees; the reference's does the same."""
    bn = _block(0).nbytes
    out = []
    for mod in (tpool, jpool):
        t = mod.KvbmTiers(bn, host_capacity_bytes=bn, disk_capacity_bytes=1 << 20,
                          disk_path=str(tmp_path / mod.__name__))
        t.store(1, _block(1))
        t.store(2, _block(2))   # 1 spills to disk
        b1, tier1 = t.get_block(1)
        b2, tier2 = t.get_block(2)
        out.append((tier1, tier2, t.tier_of(1), t.tier_of(2), t.get_block(3),
                    1 in t.host, b1.tobytes() == _block(1).tobytes(),
                    b2.tobytes() == _block(2).tobytes()))
        t.close()
    assert out[0] == out[1] == ("g3", "g2", "g3", "g2", None, False, True, True)
