"""The port's sharded G4 fleet (kvbm/distributed.py) against the
reference's, on the CPU.

- The ring: for the same members, the port's HashRing names the same
  owner as the reference's for 10 000 seeded 64-bit hashes, after adds
  and after a removal too; shards stay balanced, and a removal moves only
  the removed member's keys.
- The fleet, the counterpart of the reference's test: two port block
  stores register under a lease-less key in a MemKVStore, a
  DistributedBlockPool watches them in, shards blocks across both (each
  on the member the ring names), serves them bit for bit and batches
  ``contains_many``; when a member deregisters, its shard misses and the
  other still hits. The registration key and value are the reference's.
"""

import asyncio

import numpy as np
import pytest

from dynamo_tpu.kvbm import distributed as jdist
from dynamo_tpu.runtime.discovery.store import MemKVStore as JMemKVStore
from dynamo_tpu_torch.kvbm import distributed as tdist
from dynamo_tpu_torch.kvbm.remote import RemoteBlockStoreServer
from dynamo_tpu_torch.runtime import MemKVStore

MEMBERS = ("10.0.0.1:7440", "10.0.0.2:7440", "127.0.0.1:40123", "store-b:9")


def _hashes(n: int = 10_000, seed: int = 21):
    rng = np.random.default_rng(seed)
    return [int(h) for h in rng.integers(0, 2**63, n, dtype=np.int64) * 2 + 1]


@pytest.mark.parametrize("members", [MEMBERS[:1], MEMBERS[:2], MEMBERS[:3], MEMBERS],
                         ids=lambda m: f"{len(m)}members")
def test_ring_owners_equal_the_references(members):
    t, j = tdist.HashRing(), jdist.HashRing()
    for a in members:
        t.add(a)
        j.add(a)
    hashes = _hashes()
    assert [t.owner(h) for h in hashes] == [j.owner(h) for h in hashes]
    assert t.members() == j.members() == sorted(members)
    t.remove(members[0])
    j.remove(members[0])
    assert [t.owner(h) for h in hashes] == [j.owner(h) for h in hashes]
    assert tdist.VNODES == jdist.VNODES == 64


def test_ring_balance_and_stability():
    ring = tdist.HashRing()
    for a in ("w1:1", "w2:1", "w3:1"):
        ring.add(a)
    owners = {h: ring.owner(h) for h in range(10_000)}
    counts = {}
    for o in owners.values():
        counts[o] = counts.get(o, 0) + 1
    assert all(c > 1500 for c in counts.values()), counts
    ring.remove("w2:1")
    assert all(ring.owner(h) == o for h, o in owners.items() if o != "w2:1")
    assert tdist.HashRing().owner(5) is None


def test_registration_is_the_references():
    async def main():
        ts, js = MemKVStore(), JMemKVStore()
        await tdist.register_store(ts, "ns", "1.2.3.4:7440", None)
        await jdist.register_store(js, "ns", "1.2.3.4:7440", None)
        tk, jk = await ts.list_prefix("v1/kvbm/ns/"), await js.list_prefix("v1/kvbm/ns/")
        await ts.close()
        await js.close()
        return tk, jk

    tk, jk = asyncio.run(main())
    assert tk == jk == {"v1/kvbm/ns/1.2.3.4:7440": tk["v1/kvbm/ns/1.2.3.4:7440"]}
    assert tdist.fleet_key("ns", "a:1") == jdist.fleet_key("ns", "a:1")


def test_fleet_shards_and_survives_member_loss():
    async def main():
        store = MemKVStore()
        s1 = RemoteBlockStoreServer(host="127.0.0.1", port=0, capacity_bytes=1 << 22)
        s2 = RemoteBlockStoreServer(host="127.0.0.1", port=0, capacity_bytes=1 << 22)
        a1, a2 = await s1.start(), await s2.start()
        await tdist.register_store(store, "ns", a1, None)
        await tdist.register_store(store, "ns", a2, None)
        pool = await tdist.DistributedBlockPool(store, "ns").start()
        loop = asyncio.get_running_loop()

        # the member clients' sockets block (they live on offload threads);
        # the servers share this loop, so every pool call runs off it
        def off(fn, *a):
            return loop.run_in_executor(None, fn, *a)

        ring = jdist.HashRing()
        try:
            for _ in range(100):
                if len(pool.members()) == 2:
                    break
                await asyncio.sleep(0.02)
            assert pool.members() == sorted([a1, a2])
            ring.add(a1)
            ring.add(a2)
            rng = np.random.default_rng(1)
            blocks = {h: rng.standard_normal((2, 2, 4)).astype(np.float32)
                      for h in range(1000, 1064)}
            for h, b in blocks.items():
                await off(pool.store, h, b)
            by_addr = {a1: s1, a2: s2}
            # every block on the member the reference's ring names
            for h in blocks:
                assert h in by_addr[ring.owner(h)]._blocks
            n1, n2 = len(s1._blocks), len(s2._blocks)
            assert n1 + n2 == 64 and n1 > 0 and n2 > 0
            for h, b in blocks.items():
                assert (await off(pool.get, h)).tobytes() == b.tobytes()
            have = await off(pool.contains_many, list(blocks) + [9999])
            assert have == [True] * 64 + [False]
            # member loss: deregister and stop s1; its shard misses, s2's hits
            await store.delete(tdist.fleet_key("ns", a1))
            await s1.stop()
            for _ in range(100):
                if len(pool.members()) == 1:
                    break
                await asyncio.sleep(0.02)
            assert pool.members() == [a2]
            got = [await off(pool.get, h) for h in blocks]
            served = [h for h, g in zip(blocks, got) if g is not None]
            assert len(served) == n2 and all(ring.owner(h) == a2 for h in served)
            assert all(got[i].tobytes() == blocks[h].tobytes()
                       for i, h in enumerate(blocks) if got[i] is not None)
        finally:
            await pool.stop()
            await s2.stop()
            await s1.stop()
            await store.close()

    asyncio.run(main())


def test_an_empty_fleet_is_a_miss():
    async def main():
        store = MemKVStore()
        pool = await tdist.DistributedBlockPool(store, "ns").start()
        try:
            assert pool.members() == [] and pool.get(1) is None and 1 not in pool
            assert pool.contains_many([1, 2]) == [False, False]
            pool.store(1, np.zeros(4, np.float32))   # a no-op
        finally:
            await pool.stop()
            await store.close()

    asyncio.run(main())
