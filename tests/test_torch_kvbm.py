"""The port's KVBM tiers and block formats (dynamo_tpu_torch/kvbm) against
the JAX package's kvbm/layout.py and kvbm/pool.py.

The int8 block codec must produce the reference's bytes for the same
payload and scales; G3 block files must cross between the two packages in
both directions (bf16 blocks included: the port holds them as bit patterns,
the reference as ml_dtypes bfloat16); and the tier stack must behave the
same for the same sequence of offloads and lookups.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.kvbm import layout as jl
from dynamo_tpu.kvbm import pool as jp
from dynamo_tpu.models.llama import LlamaConfig as JConfig
from dynamo_tpu_torch.kvbm import layout as tl
from dynamo_tpu_torch.kvbm import pool as tp
from dynamo_tpu_torch.models.llama import LlamaConfig as TConfig

SHAPE = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
             num_kv_heads=2, head_dim=16, intermediate_size=128)


def _codecs():
    return (tl.QuantizedBlockCodec(tl.block_shape_for(TConfig(**SHAPE), 4, "int8")),
            jl.QuantizedBlockCodec(jl.block_shape_for(JConfig(**SHAPE), 4, "int8")))


def _pair(rng, codec, n=None):
    lead = () if n is None else (n,)
    pay = rng.integers(-127, 128, size=lead + codec.payload_shape).astype(np.int8)
    scl = rng.random(lead + codec.scales_shape).astype(np.float32)
    return pay, scl


def test_codec_bytes_equal_the_reference():
    tc, jc = _codecs()
    assert (tc.nbytes, tc.payload_nbytes, tc.scales_nbytes) == (
        jc.nbytes, jc.payload_nbytes, jc.scales_nbytes)
    rng = np.random.default_rng(0)
    pay, scl = _pair(rng, tc)
    buf = tc.encode(pay, scl)
    np.testing.assert_array_equal(buf, jc.encode(pay, scl))
    p2, s2 = tc.decode(buf)
    np.testing.assert_array_equal(p2, pay)
    np.testing.assert_array_equal(s2, scl)
    pays, scls = _pair(rng, tc, n=3)
    bufs = np.stack([tc.encode(pays[i], scls[i]) for i in range(3)])
    for got, want in zip(tc.decode_many(bufs), jc.decode_many(bufs)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["llama3_8b", "tiny"])
def test_kv_bytes_per_token_int8_is_about_half_of_bf16(name):
    cfg = getattr(TConfig, name)()
    jcfg = getattr(JConfig, name)()
    i8 = tl.kv_bytes_per_token(cfg, 16, "int8")
    bf = tl.kv_bytes_per_token(cfg, 16, "model")
    assert cfg.dtype == torch.bfloat16
    assert i8 <= 0.55 * bf
    assert (i8, bf) == (jl.kv_bytes_per_token(jcfg, 16, "int8"),
                        jl.kv_bytes_per_token(jcfg, 16, "model"))


def test_block_shape_storage_dtypes():
    assert tl.block_shape_for(TConfig(**SHAPE), 4).dtype == tl.BF16_BITS
    assert tl.block_shape_for(TConfig(dtype=torch.float32, **SHAPE), 4).dtype == np.float32
    assert tl.block_shape_for(TConfig(**SHAPE), 4, "int8").dtype == np.int8
    assert tl.dtype_name(tl.BF16_BITS) == "bfloat16"
    assert tl.dtype_from_name("bfloat16") == tl.BF16_BITS
    assert tl.dtype_from_name("int8") == np.int8
    t = torch.randn(3, 5).to(torch.bfloat16)
    assert torch.equal(tl.from_host(tl.to_host(t)), t)


def _blocks(rng):
    """One block of each stored format: bf16 pages (port: bit patterns;
    reference: ml_dtypes), f32 pages, an int8 codec buffer."""
    f = rng.standard_normal((2, 2, 4, 2, 16)).astype(np.float32)
    bits = torch.from_numpy(f).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    ref_bf16 = np.asarray(jnp.asarray(f, jnp.bfloat16))
    tc, _ = _codecs()
    buf = tc.encode(*_pair(rng, tc))
    return [(bits, ref_bf16), (f, f), (buf, buf)]


def test_g3_files_cross_between_the_packages(tmp_path):
    for i, (port_block, ref_block) in enumerate(_blocks(np.random.default_rng(1))):
        a, b = str(tmp_path / f"p{i}.kv"), str(tmp_path / f"r{i}.kv")
        tp._write_block_file(a, port_block)
        read = jp._read_block_file(a)            # the reference reads the port's file
        assert read.dtype == ref_block.dtype and read.shape == ref_block.shape
        np.testing.assert_array_equal(read.view(np.uint8), ref_block.view(np.uint8))
        jp._write_block_file(b, ref_block)
        back = tp._read_block_file(b)            # and the port reads the reference's
        assert back.dtype == port_block.dtype and back.shape == port_block.shape
        np.testing.assert_array_equal(back, port_block)
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()        # byte-identical files


def _drive(mod, tmp, nbytes):
    """The same offloads and lookups on either package's KvbmTiers: a host
    tier of 3 blocks spilling to a disk tier of 4."""
    tiers = mod.KvbmTiers(nbytes, host_capacity_bytes=3 * nbytes,
                          disk_capacity_bytes=4 * nbytes, disk_path=str(tmp))
    rng = np.random.default_rng(2)
    blocks = {h: rng.integers(0, 255, size=nbytes).astype(np.uint8) for h in range(1, 9)}
    for h in (1, 2, 3, 4, 5, 6):
        tiers.offload(h, blocks[h], priority=0 if h % 2 else 1)
    tiers.flush()
    out = {"match": tiers.match_prefix([1, 2, 3, 4, 7, 5]),
           "match_none": tiers.match_prefix([8, 1])}
    got = tiers.load_prefix([1, 2, 3, 9])
    out["load"] = got
    out["stats"] = {k: v for k, v in tiers.stats().items() if k != "errors"}
    out["clear"] = tiers.clear()
    out["after"] = tiers.match_prefix([1])
    tiers.close()
    return out, blocks


def test_tiers_behave_as_the_reference(tmp_path):
    got, blocks = _drive(tp, tmp_path / "port", 64)
    want, _ = _drive(jp, tmp_path / "ref", 64)
    np.testing.assert_array_equal(got.pop("load"), want.pop("load"))
    want["stats"] = {k: v for k, v in want["stats"].items() if k in got["stats"]}
    assert got == want
    assert got["match"] == 4 and got["stats"]["offloaded"] == 6


def test_offload_queue_priority_and_shedding():
    q = tp.OffloadQueue(max_items=3)
    for h, prio in ((1, 1), (2, 0), (3, 1), (4, 0)):
        q.put(h, np.zeros(1), prio)
    assert q.shed == 1 and len(q) == 3          # the newest priority-1 item went
    order = [q.get(timeout=0)[2] for _ in range(3)]
    assert order == [2, 4, 1]
    assert q.get(timeout=0) is None


@pytest.mark.parametrize("kv_dtype,host_blocks", [("model", 64), ("int8", 2)])
async def test_engine_onboards_from_host_and_disk_tiers(tmp_path, kv_dtype, host_blocks):
    """TorchEngine with KVBM on the CPU: float32 pages through a G2 tier,
    and int8 blocks through a G2 tier of 2 blocks that spills to G3 (so the
    onboard reads block files). After device churn the repeat onboards, is
    cached, streams the same greedy tokens, and its first onboarded device
    block equals the stored block bit for bit."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.runtime import Context
    from dynamo_tpu_torch.tokens import compute_sequence_hashes

    mcfg = TConfig(dtype=torch.float32, **SHAPE)
    nbytes = int(tl.kv_bytes_per_token(mcfg, 4, kv_dtype) * 4)
    kvbm = tp.KvbmTiers(nbytes, host_capacity_bytes=host_blocks * nbytes,
                        disk_capacity_bytes=64 * nbytes, disk_path=str(tmp_path))
    e = TorchEngine(TorchEngineConfig(
        model=mcfg, device="cpu", num_blocks=14, block_size=4, max_batch_size=2,
        max_context=128, prefill_buckets=(16, 32, 64), kv_dtype=kv_dtype,
        decode_steps=1, decode_pipeline=1), kvbm=kvbm)

    async def run(rid, tokens):
        req = PreprocessedRequest(request_id=rid, model="m", token_ids=tokens,
                                  stop=StopConditions(max_tokens=6),
                                  sampling=SamplingOptions(temperature=0.0))
        toks, cached = [], None
        async for out in e.generate(req, Context()):
            toks.extend(out.token_ids)
            cached = (out.annotations or {}).get("cached_tokens", cached)
        return toks, cached

    prompt = list(range(100, 124))
    h0 = compute_sequence_hashes(prompt, 4)[0]
    try:
        t1, _ = await run("a", prompt)
        await e.flush_offload()
        stored = kvbm.host.get(h0)
        if stored is None:
            stored = kvbm.disk.get(h0)
        stored = np.array(stored)
        for i in range(4):
            await run(f"c{i}", list(range(200 + 30 * i, 224 + 30 * i)))
        assert not e.allocator.match_prefix([h0])
        t2, cached = await run("a2", prompt)
        assert t2 == t1 and cached > 0 and kvbm.stats()["onboarded"] > 0
        if host_blocks < 8:
            assert kvbm.stats()["disk_blocks"] > 0
        (bid,) = e.allocator.match_prefix([h0])
        if kv_dtype == "int8":
            codec = tl.QuantizedBlockCodec(tl.block_shape_for(mcfg, 4, "int8"))
            pay, scl = codec.decode(stored)
            for li, (kc, vc) in enumerate(zip(e.k_caches, e.v_caches)):
                np.testing.assert_array_equal(kc.data[bid].numpy(), pay[li, 0])
                np.testing.assert_array_equal(vc.scale[bid].numpy(), scl[li, 1])
        else:
            assert stored.dtype == np.float32 and stored.shape == (2, 2, 4, 2, 16)
            for li, (kc, vc) in enumerate(zip(e.k_caches, e.v_caches)):
                np.testing.assert_array_equal(kc[bid].numpy(), stored[li, 0])
                np.testing.assert_array_equal(vc[bid].numpy(), stored[li, 1])
    finally:
        e.stop()
