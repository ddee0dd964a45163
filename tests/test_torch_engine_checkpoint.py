"""Engine checkpoint and restore (dynamo_tpu_torch/engine/checkpoint.py)
against the reference's engine/checkpoint.py, on the CPU.

- The reference's ten cases of tests/test_checkpoint.py on the port's
  functions: codec round trips, the block cap, and crash consistency
  (a partial, torn, truncated or lying checkpoint is classified, never
  served; the manifest fault dies before the commit).
- The files: the port and the reference write the same bytes, block file
  for block file and manifest for manifest, for the same pages (float32,
  bf16 and the int8 codec buffer).
- Engines: a checkpoint that the reference's ``checkpoint_engine`` writes
  from a ``TpuEngine`` restores warm into a ``TorchEngine`` with the same
  blocks, bit for bit, and the other way round; the restored engine then
  serves the prompt with the restored prefix cached and the same greedy
  tokens as the writer (float32 and int8 caches). A restore imports
  windows of 64 blocks, one import (one scatter) each.
"""

import asyncio
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest

from dynamo_tpu.engine import checkpoint as jckpt
from dynamo_tpu.kvbm.layout import BlockShape, QuantizedBlockCodec
from dynamo_tpu_torch.engine import checkpoint as tckpt
from dynamo_tpu_torch.kvbm.layout import BF16_BITS
from dynamo_tpu_torch.runtime.faults import FAULTS, FaultInjected
from dynamo_tpu_torch.tokens import compute_sequence_hashes
from torch_feature_engines import Weights, collect, request, tokens

FLOAT_FMT = {"kind": "float", "dtype": "float32", "shape": [2, 2, 4, 3, 8]}


@pytest.fixture(autouse=True)
def _disarm_faults():
    yield
    FAULTS.disarm()


def _float_blocks(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(0x1000 + i, rng.standard_normal(FLOAT_FMT["shape"]).astype(np.float32))
            for i in range(n)]


# --------------------------------------------------- the reference's ten cases
def test_float_round_trip_bit_exact(tmp_path):
    blocks = _float_blocks(5)
    manifest = tckpt.save_checkpoint(
        str(tmp_path), blocks, block_format=dict(FLOAT_FMT),
        radix_order=[h for h, _ in blocks],
        queue=[{"request_id": "r1", "state": "running", "produced": 7}],
        weights_ref="sha256:abc")
    assert manifest["blocks"] == [f"{h:016x}" for h, _ in blocks]
    state = tckpt.load_checkpoint(str(tmp_path))
    assert state.blocks == [h for h, _ in blocks] and state.radix == state.blocks
    assert state.queue == [{"request_id": "r1", "state": "running", "produced": 7}]
    assert state.weights_ref == "sha256:abc"
    for h, arr in blocks:
        got = state.load_block(h)
        assert got.dtype == arr.dtype and got.shape == arr.shape
        assert np.array_equal(got, arr)


def test_int8_codec_buffer_round_trip(tmp_path):
    codec = QuantizedBlockCodec(BlockShape(num_layers=2, block_size=4, num_kv_heads=3,
                                           head_dim=8, dtype=np.dtype(np.int8)))
    rng = np.random.default_rng(1)
    payload = rng.integers(-128, 128, size=codec.payload_shape, dtype=np.int8)
    scales = rng.standard_normal(codec.scales_shape).astype(np.float32)
    tckpt.save_checkpoint(str(tmp_path), [(0xFEED, codec.encode(payload, scales))],
                          block_format={"kind": "int8", "nbytes": codec.nbytes})
    got_payload, got_scales = codec.decode(
        tckpt.load_checkpoint(str(tmp_path)).load_block(0xFEED))
    assert np.array_equal(got_payload, payload)
    assert np.array_equal(got_scales.view(np.uint32), scales.view(np.uint32))


def test_max_blocks_caps_checkpoint(tmp_path):
    manifest = tckpt.save_checkpoint(str(tmp_path), _float_blocks(6),
                                     block_format=dict(FLOAT_FMT), max_blocks=2)
    assert len(manifest["blocks"]) == 2
    assert len(tckpt.load_checkpoint(str(tmp_path)).blocks) == 2


def test_missing_manifest_is_partial_checkpoint(tmp_path):
    os.makedirs(tmp_path / "blocks")
    with pytest.raises(tckpt.CheckpointCorrupt, match="partial"):
        tckpt.load_checkpoint(str(tmp_path))


def test_truncated_manifest_rejected(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), _float_blocks(2), block_format=dict(FLOAT_FMT))
    mpath = tmp_path / tckpt.MANIFEST_NAME
    raw = mpath.read_text()
    mpath.write_text(raw[: len(raw) // 2])
    with pytest.raises(tckpt.CheckpointCorrupt, match="unreadable"):
        tckpt.load_checkpoint(str(tmp_path))


def test_wrong_version_and_bad_structure_rejected(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), _float_blocks(1), block_format=dict(FLOAT_FMT))
    mpath = tmp_path / tckpt.MANIFEST_NAME
    doc = json.loads(mpath.read_text())
    doc["version"] = 99
    mpath.write_text(json.dumps(doc))
    with pytest.raises(tckpt.CheckpointCorrupt, match="version"):
        tckpt.load_checkpoint(str(tmp_path))
    doc["version"] = 1
    doc["blocks"] = ["not-a-hash"]
    mpath.write_text(json.dumps(doc))
    with pytest.raises(tckpt.CheckpointCorrupt, match="not a hash"):
        tckpt.load_checkpoint(str(tmp_path))


def test_manifest_naming_missing_block_rejected(tmp_path):
    blocks = _float_blocks(3)
    tckpt.save_checkpoint(str(tmp_path), blocks, block_format=dict(FLOAT_FMT))
    os.unlink(tmp_path / "blocks" / f"{blocks[1][0]:016x}.kv")
    with pytest.raises(tckpt.CheckpointCorrupt, match="missing block"):
        tckpt.load_checkpoint(str(tmp_path))


def test_torn_block_detected_on_load(tmp_path):
    blocks = _float_blocks(2)
    tckpt.save_checkpoint(str(tmp_path), blocks, block_format=dict(FLOAT_FMT))
    h = blocks[0][0]
    bpath = tmp_path / "blocks" / f"{h:016x}.kv"
    bpath.write_bytes(bpath.read_bytes()[:-16])
    state = tckpt.load_checkpoint(str(tmp_path))
    with pytest.raises(tckpt.CheckpointCorrupt):
        state.load_block(h)
    assert np.array_equal(state.load_block(blocks[1][0]), blocks[1][1])


def test_format_mismatch_rejected_per_block(tmp_path):
    blocks = _float_blocks(1)
    fmt = dict(FLOAT_FMT, shape=[2, 2, 4, 3, 4])   # the manifest lies about head_dim
    tckpt.save_checkpoint(str(tmp_path), blocks, block_format=fmt)
    state = tckpt.load_checkpoint(str(tmp_path))
    with pytest.raises(tckpt.CheckpointCorrupt, match="block format"):
        state.load_block(blocks[0][0])


def test_manifest_fault_dies_before_commit(tmp_path):
    FAULTS.arm("checkpoint.manifest:fail@1")
    with pytest.raises(FaultInjected):
        tckpt.save_checkpoint(str(tmp_path), _float_blocks(2), block_format=dict(FLOAT_FMT))
    assert not (tmp_path / tckpt.MANIFEST_NAME).exists()
    assert not [p for p in os.listdir(tmp_path) if p.startswith(tckpt.MANIFEST_NAME)]
    with pytest.raises(tckpt.CheckpointCorrupt, match="partial"):
        tckpt.load_checkpoint(str(tmp_path))
    manifest = tckpt.save_checkpoint(str(tmp_path), _float_blocks(2),
                                     block_format=dict(FLOAT_FMT))
    assert len(tckpt.load_checkpoint(str(tmp_path)).blocks) == len(manifest["blocks"])


# ------------------------------------------------------------------ the files
def _file_cases():
    rng = np.random.default_rng(4)
    shape = (2, 2, 4, 3, 8)
    f32 = [(0x2000 + i, rng.standard_normal(shape).astype(np.float32)) for i in range(3)]
    bits = [rng.integers(0, 2**16, size=shape, dtype=np.uint16) for _ in range(3)]
    codec = QuantizedBlockCodec(BlockShape(num_layers=2, block_size=4, num_kv_heads=3,
                                           head_dim=8, dtype=np.dtype(np.int8)))
    i8 = [(0x4000 + i, codec.encode(rng.integers(-128, 128, size=codec.payload_shape,
                                                 dtype=np.int8),
                                    rng.standard_normal(codec.scales_shape).astype(
                                        np.float32))) for i in range(3)]
    return {
        "float32": ({"kind": "float", "dtype": "float32", "shape": list(shape)}, f32, f32),
        # bf16: the reference's ml_dtypes arrays, the port's bit patterns
        "bfloat16": ({"kind": "float", "dtype": "bfloat16", "shape": list(shape)},
                     [(0x3000 + i, b.view(jnp.bfloat16)) for i, b in enumerate(bits)],
                     [(0x3000 + i, b.view(BF16_BITS)) for i, b in enumerate(bits)]),
        "int8": ({"kind": "int8", "nbytes": codec.nbytes}, i8, i8),
    }


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_the_files_are_the_references_byte_for_byte(tmp_path, kind):
    fmt, ref_blocks, port_blocks = _file_cases()[kind]
    kw = dict(block_format=fmt, queue=[{"request_id": "q", "state": "running",
                                        "produced": 3}], weights_ref="w0")
    jckpt.save_checkpoint(str(tmp_path / "ref"), ref_blocks, **kw)
    tckpt.save_checkpoint(str(tmp_path / "port"), port_blocks, **kw)
    names = sorted(os.listdir(tmp_path / "ref" / "blocks"))
    assert names == sorted(os.listdir(tmp_path / "port" / "blocks")) and len(names) == 3
    for name in names + ["../" + tckpt.MANIFEST_NAME]:
        assert ((tmp_path / "ref" / "blocks" / name).read_bytes()
                == (tmp_path / "port" / "blocks" / name).read_bytes()), name
    # each reads the other's blocks to the same bits
    for h, arr in port_blocks:
        got = jckpt.load_checkpoint(str(tmp_path / "port")).load_block(h)
        assert got.tobytes() == arr.tobytes()
    for h, arr in ref_blocks:
        assert tckpt.load_checkpoint(str(tmp_path / "ref")).load_block(h).tobytes() == (
            arr.tobytes())


# ---------------------------------------------------------------- the engines
MODEL = dict(vocab_size=256, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
BS = 4
ENGINE = dict(num_blocks=96, block_size=BS, max_batch_size=4, max_context=160,
              prefill_buckets=(16, 32, 64))
PROMPT = tokens(21, 90, 256)   # 22 full blocks
N_OUT = 10


def _pages(engine, hashes) -> bytes:
    """The pages of ``hashes`` in either engine, block by block, as the
    storage format (a G3 block file's bytes)."""
    ids = engine.allocator.match_prefix(hashes)
    assert len(ids) == len(hashes)
    if hasattr(engine, "_storage_blocks"):   # the port
        gathered, _ = engine._enqueue_offload_gather([(b, h, 0) for b, h in zip(ids, hashes)])
        return b"".join(a.tobytes() for a in engine._storage_blocks(gathered, len(ids)))
    pending = [(b, h, 0) for b, h in zip(ids, hashes)]
    arrs = jckpt._encode_gathered(engine, pending, engine._enqueue_offload_gather(pending))
    return b"".join(np.ascontiguousarray(a).view(np.uint8).tobytes() for a in arrs)


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_a_checkpoint_restores_warm_across_packages(tmp_path, writer, kv):
    w = Weights(MODEL)

    def engines():
        jax_eng = w.jax_engine(ENGINE, kv_dtype=kv)
        port_eng = w.torch_engine(ENGINE, kv_dtype=kv, decode_steps=1, decode_pipeline=1)
        return (jax_eng, port_eng) if writer == "reference" else (port_eng, jax_eng)

    async def main():
        src, dst = engines()
        jax_src = writer == "reference"
        try:
            first = await collect(src, request(jax_src, "w", PROMPT, N_OUT))
            mod = jckpt if jax_src else tckpt
            manifest = await mod.checkpoint_engine(src, str(tmp_path), weights_ref="ref")
            hashes = [int(h, 16) for h in manifest["blocks"]]
            restored = await (tckpt if jax_src else jckpt).restore_engine(dst, str(tmp_path))
            assert restored["mode"] == "warm" and restored["blocks"] == len(hashes) > 0
            assert _pages(dst, hashes) == _pages(src, hashes)
            again = await collect(dst, request(not jax_src, "r", PROMPT, N_OUT))
            return first, again, hashes, restored
        finally:
            src.stop()
            dst.stop()

    first, again, hashes, restored = asyncio.run(main())
    prompt_hashes = [int(h) for h in compute_sequence_hashes(PROMPT, BS)]
    reusable = (len(PROMPT) - 1) // BS
    assert set(prompt_hashes[:reusable]) <= set(hashes)
    assert again["cached"] == reusable * BS
    assert again["tokens"] == first["tokens"]


def test_the_restore_imports_windows_of_64(tmp_path):
    """A 130-block checkpoint restores in three imports (64, 64, 2), each
    one scatter; a torn last block leaves the warm prefix (partial)."""
    w = Weights(MODEL)
    shape = [MODEL["num_layers"], 2, BS, MODEL["num_kv_heads"], MODEL["head_dim"]]
    rng = np.random.default_rng(6)
    blocks = [(0x9000 + i, rng.standard_normal(shape).astype(np.float32)) for i in range(130)]
    tckpt.save_checkpoint(str(tmp_path), blocks,
                          block_format={"kind": "float", "dtype": "float32", "shape": shape})

    async def main(engine):
        imports = []
        real = engine.import_blocks

        async def spy(hashes, arr, **kw):
            imports.append(len(hashes))
            return await real(hashes, arr, **kw)

        engine.import_blocks = spy
        try:
            return await tckpt.restore_engine(engine, str(tmp_path)), imports
        finally:
            engine.stop()

    got, imports = asyncio.run(main(w.torch_engine(dict(ENGINE, num_blocks=160))))
    assert (got["mode"], got["blocks"], got["windows"], imports) == ("warm", 130, 3, [64, 64, 2])
    bpath = tmp_path / "blocks" / f"{blocks[-1][0]:016x}.kv"
    bpath.write_bytes(bpath.read_bytes()[:-8])
    got, imports = asyncio.run(main(w.torch_engine(dict(ENGINE, num_blocks=160))))
    assert (got["mode"], got["blocks"], imports) == ("partial", 128, [64, 64])
