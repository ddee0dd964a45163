"""The port's int8 paged-KV format (dynamo_tpu_torch/ops/quant.py) and the
int8 branches of its attention ops, against the JAX package.

Quantization is held BIT-identical to dynamo_tpu/ops/quant.py on the same
float32 inputs (payload and scales). The int8 plain attention ops are held
to their JAX twins at the float32 reference tolerance 2e-5, and the plain
versions of the int8 decode and flash-extend kernels to the Pallas kernels
they replace, run in interpret mode with the same QuantizedKV caches, at the
same 2e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import pallas_prefill as pf
from dynamo_tpu.ops import pallas_unified as pun
from dynamo_tpu.ops import quant as jq
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified
from dynamo_tpu_torch.ops import quant as tq

TOL = 2e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _blocks(seed, shape=(6, 4, 2, 16)):
    """Random blocks plus the edge cases: an all-zero block, a block whose
    values sit exactly on rounding ties, and one with a single outlier."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 30, size=(shape[0], 1, 1, 1)))
    x = x.astype(np.float32)
    x[1] = 0.0
    x[2] = np.arange(np.prod(shape[1:])).reshape(shape[1:]) % 255 - 127.0
    x[2] *= 0.5    # amax 63.5 -> scale 0.5: every x / scale is a .0 or a tie
    x[3, 0, 0, 0] = 1e4
    return x


# ----------------------------------------------------------- quantization
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_blocks_bit_identical_to_jax(seed):
    x = _blocks(seed)
    wq, ws = jq.quantize_blocks(jnp.asarray(x))
    gq, gs = tq.quantize_blocks(_t(x))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(gs.numpy().view(np.uint32), np.asarray(ws).view(np.uint32))
    np.testing.assert_array_equal(
        tq.dequantize_blocks(gq, gs).numpy(), np.asarray(jq.dequantize_blocks(wq, ws)))


@pytest.mark.parametrize("seed", [0, 3])
def test_numpy_mirrors_bit_identical(seed):
    """The port's numpy mirrors equal the reference's and the port's own
    torch versions."""
    x = _blocks(seed)
    pq, ps = tq.quantize_blocks_np(x)
    rq, rs = jq.quantize_blocks_np(x)
    np.testing.assert_array_equal(pq, rq)
    np.testing.assert_array_equal(ps.view(np.uint32), rs.view(np.uint32))
    gq, gs = tq.quantize_blocks(_t(x))
    np.testing.assert_array_equal(pq, gq.numpy())
    np.testing.assert_array_equal(ps, gs.numpy())
    np.testing.assert_array_equal(tq.dequantize_blocks_np(pq, ps),
                                  jq.dequantize_blocks_np(rq, rs))


@pytest.mark.parametrize("grow", [0.5, 1.0, 3.0])
def test_requantize_token_bit_identical_to_jax(grow):
    """A new row below, at and above the block's amax: the scale keeps,
    keeps, grows (and the block's ints rescale)."""
    x = _blocks(4, (4, 4, 2, 16))
    bq, bs = jq.quantize_blocks_np(x)
    rng = np.random.default_rng(5)
    new = rng.standard_normal((4, 2, 16)).astype(np.float32)
    new *= grow * (np.abs(x).max(axis=(1, 3))[:, :, None] + 1.0) / np.abs(new).max(
        axis=2, keepdims=True)
    want = jq.requantize_token(*map(jnp.asarray, (bq, bs, new)))
    got = tq.requantize_token(*map(_t, (bq, bs, new)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_scale_saturated_block_round_trips_bit_exactly():
    q, s = tq.quantize_blocks(_t(_blocks(6)))
    q2, s2 = tq.quantize_blocks(tq.dequantize_blocks(q, s))
    assert torch.equal(q2, q) and torch.equal(s2, s)


def test_resolve_kv_dtype_env(monkeypatch):
    monkeypatch.setenv("DTPU_KV_DTYPE", "int8")
    assert tq.resolve_kv_dtype("auto") == "int8"
    monkeypatch.delenv("DTPU_KV_DTYPE")
    assert tq.resolve_kv_dtype("auto") == "model"
    assert tq.resolve_kv_dtype("float") == "model"
    with pytest.raises(ValueError, match="kv_dtype"):
        tq.resolve_kv_dtype("fp8")
    qkv = tq.QuantizedKV(torch.zeros(3, 4, 2, 8, dtype=torch.int8), torch.zeros(3, 2))
    assert qkv.shape == (3, 4, 2, 8) and qkv.dtype == torch.int8
    assert tq.is_quantized(qkv) and not tq.is_quantized(qkv.data)


# ------------------------------------------------------ int8 attention ops
def _qcache(rng, nb=32, bs=8, kvh=2, d=16):
    x = (rng.standard_normal((nb, bs, kvh, d)) * 2).astype(np.float32)
    return tq.quantize_blocks_np(x)


def _pair(jax_side, q, s):
    if jax_side:
        return jq.QuantizedKV(jnp.asarray(q), jnp.asarray(s))
    return tq.QuantizedKV(_t(q.copy()), _t(s.copy()))


def _paged(rng, lens, h=8, kvh=2, d=16, bs=8, nb=32, mb=6):
    q = rng.standard_normal((len(lens), h, d)).astype(np.float32)
    kc, vc = _qcache(rng, nb, bs, kvh, d), _qcache(rng, nb, bs, kvh, d)
    tables = np.zeros((len(lens), mb), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for b, n in enumerate(lens):
        for j in range(-(-n // bs)):
            tables[b, j] = free.pop()
    return q, kc, vc, tables, np.asarray(lens, np.int32)


def test_gathers_match_jax():
    rng = np.random.default_rng(10)
    _, kc, vc, tables, _ = _paged(rng, [20])
    table = tables[0]
    wk, wv = jatt.gather_kv(_pair(True, *kc), _pair(True, *vc), jnp.asarray(table))
    gk, gv = tatt.gather_kv(_pair(False, *kc), _pair(False, *vc), _t(table))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    want = jatt.gather_kv_quant(_pair(True, *kc), _pair(True, *vc), jnp.asarray(table))
    got = tatt.gather_kv_quant(_pair(False, *kc), _pair(False, *vc), _t(table))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_write_prefill_kv_int8_matches_jax():
    rng = np.random.default_rng(11)
    kc, vc = _qcache(rng), _qcache(rng)
    kn = rng.standard_normal((16, 2, 16)).astype(np.float32)
    vn = rng.standard_normal((16, 2, 16)).astype(np.float32)
    ids = np.asarray([7, 30], np.int32)
    wk, wv = jatt.write_prefill_kv(_pair(True, *kc), _pair(True, *vc),
                                   jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ids))
    gk, gv = tatt.write_prefill_kv(_pair(False, *kc), _pair(False, *vc), _t(kn), _t(vn), _t(ids))
    for g, w in ((gk, wk), (gv, wv)):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.scale.numpy(), np.asarray(w.scale))


def test_write_decode_kv_int8_matches_jax():
    """Rows at offset 0 of a recycled block (scale reset), mid-block with a
    growing and a kept scale, and two inactive rows on scratch block 0."""
    rng = np.random.default_rng(12)
    kc, vc = _qcache(rng), _qcache(rng)
    kn = rng.standard_normal((5, 2, 16)).astype(np.float32) * [[[0.01]], [[5.0]], [[0.1]],
                                                             [[1.0]], [[1.0]]]
    vn = rng.standard_normal((5, 2, 16)).astype(np.float32)
    kn, vn = kn.astype(np.float32), vn.astype(np.float32)
    ids = np.asarray([4, 9, 13, 0, 0], np.int32)
    offs = np.asarray([0, 5, 3, 0, 0], np.int32)
    wk, wv = jatt.write_decode_kv(_pair(True, *kc), _pair(True, *vc),
                                  *map(jnp.asarray, (kn, vn, ids, offs)))
    gk, gv = tatt.write_decode_kv(_pair(False, *kc), _pair(False, *vc),
                                  *map(_t, (kn, vn, ids, offs)))
    for g, w in ((gk, wk), (gv, wv)):
        live = [4, 9, 13]
        np.testing.assert_array_equal(g.data.numpy()[live], np.asarray(w.data)[live])
        np.testing.assert_array_equal(g.scale.numpy()[live], np.asarray(w.scale)[live])
    # the recycled block's small token survives (scale reset at offset 0)
    assert np.abs(gk.data.numpy()[4, 0]).max() == 127


@pytest.mark.parametrize("lens", [[1, 17, 33, 40], [7, 24]])
def test_paged_decode_int8_matches_jax(lens):
    rng = np.random.default_rng(13)
    q, kc, vc, tables, sl = _paged(rng, lens)
    want = jatt.paged_decode_attention(jnp.asarray(q), _pair(True, *kc), _pair(True, *vc),
                                       jnp.asarray(tables), jnp.asarray(sl))
    got = tatt.paged_decode_attention(_t(q), _pair(False, *kc), _pair(False, *vc),
                                      _t(tables), _t(sl))
    _close(got, want)


def test_ragged_paged_attention_int8_matches_jax():
    rng = np.random.default_rng(14)
    rows = [(13, 29), (1, 9), (0, 5), (1, 40)]
    _, kc, vc, tables, sl = _paged(rng, [s for _, s in rows])
    starts = np.asarray([0, 16, 20, 24], np.int32)
    qlens = np.asarray([r for r, _ in rows], np.int32)
    q = rng.standard_normal((28, 8, 16)).astype(np.float32)
    want = jatt.ragged_paged_attention(
        jnp.asarray(q), _pair(True, *kc), _pair(True, *vc),
        *map(jnp.asarray, (tables, starts, qlens, sl)))
    got = tatt.ragged_paged_attention(_t(q), _pair(False, *kc), _pair(False, *vc),
                                      *map(_t, (tables, starts, qlens, sl)))
    _close(got, want)
    got_kernel_plain = cuda_unified.ragged_paged_attention(
        _t(q), _pair(False, *kc), _pair(False, *vc), *map(_t, (tables, starts, qlens, sl)))
    _close(got_kernel_plain, want)


# ------------------------------------- int8 kernel plain versions vs Pallas
@pytest.mark.parametrize("lens", [[5, 16, 47], [1, 2, 33, 48]])
def test_decode_int8_plain_matches_pallas_interpret(lens):
    rng = np.random.default_rng(15)
    q, kc, vc, tables, sl = _paged(rng, lens, d=32, bs=16, mb=3)
    want = pa.paged_decode_attention(
        jnp.asarray(q), _pair(True, *kc), _pair(True, *vc), jnp.asarray(tables),
        jnp.asarray(sl), chunk_tokens=16, interpret=True,
    )
    got = cuda_attention.paged_decode_attention(
        _t(q), _pair(False, *kc), _pair(False, *vc), _t(tables), _t(sl))
    _close(got, want)


@pytest.mark.parametrize("start,total", [(0, 128), (100, 228)])
def test_flash_extend_int8_plain_matches_pallas_interpret(start, total):
    """int8 context with per-position scales (gather_kv_quant's form)."""
    rng = np.random.default_rng(16)
    S, h, kvh, d, bs = 128, 8, 2, 32, 16
    kc, vc = _qcache(rng, 20, bs, kvh, d), _qcache(rng, 20, bs, kvh, d)
    table = np.arange(1, 17, dtype=np.int32)            # 256 context positions
    kq, vq, ks, vs = jatt.gather_kv_quant(_pair(True, *kc), _pair(True, *vc),
                                          jnp.asarray(table))
    q = rng.standard_normal((S, h, d)).astype(np.float32)
    pos = jnp.arange(start, start + S, dtype=jnp.int32)
    want = pf.flash_extend_attention(
        jnp.asarray(q), kq, vq, pos, jnp.int32(total), k_scales=ks, v_scales=vs,
        q_tile=64, kv_tile=64, interpret=True,
    )
    got = cuda_prefill.flash_extend_attention(
        _t(q), *(_t(np.asarray(a)) for a in (kq, vq)), start, total,
        k_scales=_t(np.asarray(ks)), v_scales=_t(np.asarray(vs)))
    _close(got, want)


def test_unified_int8_plain_matches_pallas_interpret():
    rng = np.random.default_rng(17)
    rows = [(13, 29), (1, 9), (0, 5), (1, 40)]
    _, kc, vc, tables, sl = _paged(rng, [s for _, s in rows])
    starts = np.asarray([0, 16, 20, 24], np.int32)
    qlens = np.asarray([r for r, _ in rows], np.int32)
    q = rng.standard_normal((28, 8, 16)).astype(np.float32)
    want = pun.ragged_paged_attention(
        jnp.asarray(q), _pair(True, *kc), _pair(True, *vc),
        *map(jnp.asarray, (tables, starts, qlens, sl)), q_seg=4, chunk_tokens=32,
        interpret=True,
    )
    got = cuda_unified.ragged_paged_attention(
        _t(q), _pair(False, *kc), _pair(False, *vc), *map(_t, (tables, starts, qlens, sl)))
    _close(got, want)
