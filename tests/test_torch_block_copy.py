"""The port's block moves (dynamo_tpu_torch/ops/block_copy.py) against the
JAX package's block-copy kernels, run in the Pallas interpreter as
tests/test_pallas_ops.py runs them, and against their ``*_ref`` twins.

Block moves copy bytes, so every comparison is BIT-exact, on float32 pages,
on int8 payload pages and on f32 scale rows, and for the int8 pair
wrappers that move payload and scales together.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import block_copy as jbc
from dynamo_tpu.ops import quant as jq
from dynamo_tpu_torch.ops import block_copy as tbc
from dynamo_tpu_torch.ops import quant as tq


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))


CACHES = {
    "f32_pages": lambda rng: rng.standard_normal((24, 4, 2, 16)).astype(np.float32),
    "int8_pages": lambda rng: rng.integers(-127, 128, size=(24, 4, 2, 16)).astype(np.int8),
    "scale_rows": lambda rng: rng.random((24, 2)).astype(np.float32),
}
IDS = [[5], [1, 23, 7, 0], [3, 9, 14, 2, 20, 11]]


@pytest.mark.parametrize("kind", sorted(CACHES))
@pytest.mark.parametrize("ids", IDS, ids=len)
def test_gather_blocks_bit_exact(kind, ids):
    cache = CACHES[kind](np.random.default_rng(1))
    jids = jnp.asarray(ids, jnp.int32)
    want = jbc.gather_blocks(jnp.asarray(cache), jids, interpret=True)
    _same(tbc.gather_blocks(_t(cache), _t(np.asarray(ids, np.int32))), want)
    _same(tbc.gather_blocks_ref(_t(cache), _t(np.asarray(ids, np.int32))),
          jbc.gather_blocks_ref(jnp.asarray(cache), jids))


@pytest.mark.parametrize("kind", sorted(CACHES))
@pytest.mark.parametrize("ids", IDS, ids=len)
def test_scatter_blocks_bit_exact(kind, ids):
    rng = np.random.default_rng(2)
    cache = CACHES[kind](rng)
    blocks = CACHES[kind](rng)[: len(ids)]
    jids = jnp.asarray(ids, jnp.int32)
    want = jbc.scatter_blocks(jnp.asarray(cache), jids, jnp.asarray(blocks), interpret=True)
    got = _t(cache.copy())
    out = tbc.scatter_blocks(got, _t(np.asarray(ids, np.int32)), _t(blocks))
    assert out is got    # in place
    _same(got, want)
    _same(tbc.scatter_blocks_ref(_t(cache.copy()), _t(np.asarray(ids, np.int32)), _t(blocks)),
          jbc.scatter_blocks_ref(jnp.asarray(cache), jids, jnp.asarray(blocks)))


@pytest.mark.parametrize("kind", sorted(CACHES))
def test_copy_blocks_bit_exact(kind):
    cache = CACHES[kind](np.random.default_rng(3))
    src, dst = [1, 3, 17], [10, 11, 0]
    want = jbc.copy_blocks(jnp.asarray(cache), jnp.asarray(src, jnp.int32),
                           jnp.asarray(dst, jnp.int32), interpret=True)
    got = _t(cache.copy())
    assert tbc.copy_blocks(got, torch.tensor(src, dtype=torch.int32),
                           torch.tensor(dst, dtype=torch.int32)) is got
    _same(got, want)
    _same(tbc.copy_blocks_ref(_t(cache.copy()), torch.tensor(src), torch.tensor(dst)),
          jbc.copy_blocks_ref(jnp.asarray(cache), jnp.asarray(src), jnp.asarray(dst)))


def test_copy_blocks_refuses_overlapping_ids():
    cache = torch.zeros(8, 2)
    with pytest.raises(ValueError, match="share pages"):
        tbc.copy_blocks(cache, torch.tensor([1, 2]), torch.tensor([2, 5]))


def test_quant_pair_wrappers_bit_exact():
    """Payload and scale rows move together, as the reference's pair
    wrappers (in interpret mode) move them."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((20, 4, 2, 16)).astype(np.float32)
    q, s = tq.quantize_blocks_np(x)
    ids = [7, 2, 19]
    jcache = jq.QuantizedKV(jnp.asarray(q), jnp.asarray(s))
    tcache = tq.QuantizedKV(_t(q.copy()), _t(s.copy()))
    want = jbc.gather_blocks_quant(jcache, jnp.asarray(ids, jnp.int32), interpret=True)
    got = tbc.gather_blocks_quant(tcache, torch.tensor(ids, dtype=torch.int32))
    _same(got.data, want.data)
    _same(got.scale, want.scale)
    bq, bs = tq.quantize_blocks_np(rng.standard_normal((3, 4, 2, 16)).astype(np.float32))
    want = jbc.scatter_blocks_quant(jcache, jnp.asarray(ids, jnp.int32),
                                    jq.QuantizedKV(jnp.asarray(bq), jnp.asarray(bs)),
                                    interpret=True)
    got = tbc.scatter_blocks_quant(tcache, torch.tensor(ids, dtype=torch.int32),
                                   tq.QuantizedKV(_t(bq), _t(bs)))
    assert got is tcache
    _same(tcache.data, want.data)
    _same(tcache.scale, want.scale)


# ------------------------------------------- every layer at once (KVBM moves)
L_LAYERS, NB = 3, 12
LAYER_IDS = [7, 2, 11, 0, 5]


def _layer_caches(kind, seed=5):
    """numpy K and V caches of L_LAYERS layers: bf16 bit patterns (uint16),
    or the int8 pair (payload, f32 scales) of quantized float32 pages."""
    rng = np.random.default_rng(seed)
    if kind == "bf16":
        x = rng.standard_normal((2, L_LAYERS, NB, 4, 2, 16)).astype(np.float32)
        return torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    x = rng.standard_normal((2, L_LAYERS, NB, 4, 2, 16)).astype(np.float32)
    return tq.quantize_blocks_np(x.reshape(-1, 4, 2, 16))


def _torch_caches(kind, arrays):
    """numpy layer caches -> (k_caches, v_caches) of the port (fresh copies)."""
    if kind == "bf16":
        t = torch.from_numpy(arrays.copy().view(np.int16)).view(torch.bfloat16)
        return [list(t[0]), list(t[1])]
    q, s = arrays
    q = q.reshape(2, L_LAYERS, NB, 4, 2, 16)
    s = s.reshape(2, L_LAYERS, NB, 2)
    return [[tq.QuantizedKV(_t(q[kv, li].copy()), _t(s[kv, li].copy())) for li in range(L_LAYERS)]
            for kv in range(2)]


def _jax_stacked(kind, arrays, ids):
    """The JAX package's gather_blocks_ref per layer and K/V, stacked
    [n, L, 2, ...] with numpy: the host layout the engine offloads."""
    jids = jnp.asarray(ids, jnp.int32)
    if kind == "bf16":
        c = jnp.asarray(arrays)
        return np.stack([np.stack([np.asarray(jbc.gather_blocks_ref(c[kv, li], jids))
                                   for kv in range(2)], 1) for li in range(L_LAYERS)], 1)
    q, s = arrays
    q = q.reshape(2, L_LAYERS, NB, 4, 2, 16)
    s = s.reshape(2, L_LAYERS, NB, 2)
    return tuple(np.stack([np.stack([np.asarray(jbc.gather_blocks_ref(jnp.asarray(a[kv, li]),
                                                                       jids))
                                     for kv in range(2)], 1) for li in range(L_LAYERS)], 1)
                 for a in (q, s))


def _as_numpy(pages):
    if isinstance(pages, tq.QuantizedKV):
        return pages.data.numpy(), pages.scale.numpy()
    return pages.view(torch.int16).numpy().view(np.uint16)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_gather_layers_bit_exact_against_per_layer_stack_and_jax(kind):
    arrays = _layer_caches(kind)
    ks, vs = _torch_caches(kind, arrays)
    ids = torch.tensor(LAYER_IDS, dtype=torch.int32)
    got = tbc.gather_layers_ref(ks, vs, ids)
    parts = (lambda c: [c]) if kind == "bf16" else (lambda c: [c.data, c.scale])
    stacked = [torch.stack([torch.stack((tbc.gather_blocks_ref(a, ids),
                                         tbc.gather_blocks_ref(b, ids)), 1)
                            for a, b in zip(ka, va)], 1)
               for ka, va in zip(zip(*map(parts, ks)), zip(*map(parts, vs)))]
    want_jax = _jax_stacked(kind, arrays, LAYER_IDS)
    got_np = _as_numpy(got)
    for g, w, j in zip(got_np if kind == "int8" else [got_np],
                       [_as_numpy(s) if kind == "bf16" else s.numpy() for s in stacked],
                       want_jax if kind == "int8" else [want_jax]):
        assert g.shape == (len(LAYER_IDS), L_LAYERS, 2, *g.shape[3:])
        _same(_t(g), w)
        _same(_t(g), j)
    # the wrapper on CPU tensors is the plain version
    wrapped = _as_numpy(tbc.gather_layers(ks, vs, ids))
    for g, w in zip(wrapped if kind == "int8" else [wrapped],
                    got_np if kind == "int8" else [got_np]):
        _same(_t(g), w)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_scatter_layers_bit_exact_against_per_layer_scatter(kind):
    arrays = _layer_caches(kind)
    src_k, src_v = _torch_caches(kind, _layer_caches(kind, seed=9))
    pages = tbc.gather_layers_ref(src_k, src_v, torch.tensor([1, 3, 4], dtype=torch.int32))
    ids = torch.tensor([10, 0, 6], dtype=torch.int32)
    ks, vs = _torch_caches(kind, arrays)
    tbc.scatter_layers(ks, vs, ids, pages)
    wk, wv = _torch_caches(kind, arrays)
    for li in range(L_LAYERS):
        for kv, caches in enumerate((wk, wv)):
            c = caches[li]
            if kind == "bf16":
                tbc.scatter_blocks_ref(c, ids, pages[:, li, kv])
            else:
                tbc.scatter_blocks_quant(c, ids, tq.QuantizedKV(pages.data[:, li, kv],
                                                                pages.scale[:, li, kv]))
    for got, want in zip(ks + vs, wk + wv):
        for g, w in ([(got, want)] if kind == "bf16"
                     else [(got.data, want.data), (got.scale, want.scale)]):
            assert torch.equal(g.view(torch.uint8) if g.dtype != torch.int8 else g,
                               w.view(torch.uint8) if w.dtype != torch.int8 else w)
    # gathering the scattered pages back gives the pages
    back = _as_numpy(tbc.gather_layers_ref(ks, vs, ids))
    for g, w in zip(back if kind == "int8" else [back],
                    _as_numpy(pages) if kind == "int8" else [_as_numpy(pages)]):
        _same(_t(g), w)


def _emulate(table, W, src_ids, dst_ids, M, memory, bases):
    """csrc/block_copy.cu's page_move_kernel on a numpy byte array standing
    for device memory (addresses are offsets into it): every (page index,
    entry, chunk) item, as the kernel walks them."""
    for m in range(M):
        for w in range(W):
            e = table[np.searchsorted(table["w0"], w, side="right") - 1]
            flags = int(e["flags"])
            s = src_ids[m] if flags & tbc.SRC_IDS else m
            d = dst_ids[m] if flags & tbc.DST_IDS else m
            if flags & tbc.DST_IDS and not 0 <= d < e["dst_limit"]:
                continue
            ok = not flags & tbc.SRC_IDS or 0 <= s < e["src_limit"]
            sb = bases[(flags >> 2) & 3] + int(e["src"]) + (s * int(e["src_stride"]) if ok else 0)
            db = bases[(flags >> 4) & 3] + int(e["dst"]) + d * int(e["dst_stride"])
            c0 = (w - int(e["w0"])) * tbc.CHUNK_BYTES
            c1 = min(c0 + tbc.CHUNK_BYTES, int(e["page_bytes"]))
            memory[db + c0:db + c1] = memory[sb + c0:sb + c1] if ok else 0


@pytest.mark.parametrize("gather", [True, False])
def test_layer_moves_address_the_stacked_layout(gather):
    """The host-side descriptor builder: entry i of layer_moves (array i in
    stacked order) reads or writes page m at byte ``m * row + i * page`` of
    the launch buffer, ``row`` the sum of the arrays' pages (the layout of
    a contiguous [n, L, 2, ...] tensor), with the cache side indexed by the
    ids; W counts every entry's 4 KiB chunks. The kernel's walk over the
    table, emulated on a byte array, moves exactly what
    gather_layers_ref / scatter_layers_ref move, payload pages larger than
    a chunk and 8-byte scale rows alike."""
    rng = np.random.default_rng(3)
    nb, n, L = 9, 4, 2
    pay_page, scl_page = 5000, 8   # a payload page spans two chunks
    caches = [rng.integers(0, 256, size=nb * pay_page, dtype=np.uint8) for _ in range(2 * L)]
    scales = [rng.integers(0, 256, size=nb * scl_page, dtype=np.uint8) for _ in range(2 * L)]
    ids = np.asarray([8, 0, 3, 5], np.int32)
    # device memory: the caches one after another, then the two buffers
    memory = np.concatenate(caches + scales)
    addr = np.cumsum([0] + [a.size for a in caches + scales])[:-1].tolist()
    buf0, buf1 = memory.size, memory.size + n * 2 * L * pay_page
    stacked_pay = rng.integers(0, 256, size=(n, L, 2, pay_page), dtype=np.uint8)
    stacked_scl = rng.integers(0, 256, size=(n, L, 2, scl_page), dtype=np.uint8)
    memory = np.concatenate([memory, stacked_pay.ravel(), stacked_scl.ravel()])
    moves = (tbc.layer_moves([(a, pay_page) for a in addr[:2 * L]], nb, gather, 1)
             + tbc.layer_moves([(a, scl_page) for a in addr[2 * L:]], nb, gather, 2))
    table, W = tbc.move_table(moves)
    assert W == 2 * L * 2 + 2 * L
    assert table.dtype.itemsize == 64
    assert list(table["nchunk"]) == [2] * (2 * L) + [1] * (2 * L)
    assert list(table["w0"]) == list(range(0, 4 * L, 2)) + list(range(4 * L, 6 * L))
    row = 2 * L * pay_page
    assert all(e["dst_stride" if gather else "src_stride"] == row for e in table[:2 * L])
    assert [int(e["dst" if gather else "src"]) for e in table[:2 * L]] == [
        i * pay_page for i in range(2 * L)]
    _emulate(table, W, ids, ids, n, memory, [0, buf0, buf1])
    pay = [torch.from_numpy(memory[a:a + nb * pay_page].reshape(nb, pay_page).copy())
           for a in addr[:2 * L]]
    scl = [torch.from_numpy(memory[a:a + nb * scl_page].reshape(nb, scl_page).copy())
           for a in addr[2 * L:]]
    got_pay = memory[buf0:buf0 + stacked_pay.size].reshape(stacked_pay.shape)
    got_scl = memory[buf1:buf1 + stacked_scl.size].reshape(stacked_scl.shape)
    tids = torch.from_numpy(ids)
    if gather:
        before = [torch.from_numpy(c.reshape(nb, pay_page)) for c in caches]
        want = tbc.gather_layers_ref(before[0::2], before[1::2], tids)
        np.testing.assert_array_equal(got_pay, want.numpy())
        before = [torch.from_numpy(c.reshape(nb, scl_page)) for c in scales]
        np.testing.assert_array_equal(got_scl, tbc.gather_layers_ref(
            before[0::2], before[1::2], tids).numpy())
    else:
        for got, orig, stacked, page in ((pay, caches, stacked_pay, pay_page),
                                         (scl, scales, stacked_scl, scl_page)):
            want = [torch.from_numpy(c.reshape(nb, page).copy()) for c in orig]
            tbc.scatter_layers_ref(want[0::2], want[1::2], tids, torch.from_numpy(stacked))
            for g, w in zip(got, want):
                assert torch.equal(g, w)


def test_move_table_passes_small_moves_by_value():
    """The single-array and pair wrappers pass their entries in the launch
    (at most 4); an id outside the indexed side's pages is left
    to the kernel (gather writes zeros), so the limits are the page counts."""
    mv = tbc.Move(100, 200, 32, 32, 32, 24, 0, tbc.SRC_IDS)
    table, W = tbc.move_table([mv, mv])
    assert W == 2 and list(table["w0"]) == [0, 1] and list(table["src_limit"]) == [24, 24]
    assert tbc.rel_src(2) >> 2 & 3 == 2 and tbc.rel_dst(1) >> 4 & 3 == 1


@pytest.mark.parametrize("kv_dtype", ["model", "int8"])
def test_engine_offload_then_onboard_round_trip_bit_exact(kv_dtype):
    """TorchEngine(device="cpu"): pages offloaded by the engine's one-gather
    path reach the host tier in the storage format and scatter back, by the
    one-scatter onboard path, into other device pages bit for bit, every
    layer's K and V (and int8 scale rows)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.kvbm import layout as tl
    from dynamo_tpu_torch.kvbm import pool as tp
    from dynamo_tpu_torch.models.llama import LlamaConfig

    mcfg = LlamaConfig(vocab_size=256, hidden_size=32, num_layers=3, num_heads=4,
                       num_kv_heads=2, head_dim=16, intermediate_size=64,
                       dtype=torch.bfloat16)
    nbytes = int(tl.kv_bytes_per_token(mcfg, 4, kv_dtype) * 4)
    kvbm = tp.KvbmTiers(nbytes, host_capacity_bytes=8 * nbytes)
    e = TorchEngine(TorchEngineConfig(model=mcfg, device="cpu", num_blocks=16, block_size=4,
                                      max_batch_size=2, max_context=64,
                                      prefill_buckets=(16, 32), kv_dtype=kv_dtype,
                                      decode_steps=1, decode_pipeline=1), kvbm=kvbm)
    try:
        g = torch.Generator().manual_seed(1)
        for c in e.k_caches + e.v_caches:
            if kv_dtype == "int8":
                c.data.copy_(torch.randint(-127, 128, c.data.shape, generator=g))
                c.scale.copy_(torch.rand(c.scale.shape, generator=g))
            else:
                c.copy_(torch.randn(c.shape, generator=g).to(c.dtype))
        pending = [(5, 1001, 0), (9, 1002, 1), (2, 1003, 1)]
        e._offload_fetch(pending, *e._enqueue_offload_gather(pending))
        kvbm.flush()
        assert e.offload_errors == 0
        arr = kvbm.load_prefix([1001, 1002, 1003])
        if kv_dtype == "int8":
            arr = e._codec.decode_many(arr)
        e._scatter_blocks([12, 13, 14], arr)
        for c in e.k_caches + e.v_caches:
            for src, dst in ((5, 12), (9, 13), (2, 14)):
                if kv_dtype == "int8":
                    assert torch.equal(c.data[dst], c.data[src])
                    assert torch.equal(c.scale[dst].view(torch.int32),
                                       c.scale[src].view(torch.int32))
                else:
                    assert torch.equal(c[dst].view(torch.int16), c[src].view(torch.int16))
    finally:
        e.stop()
        kvbm.close()
