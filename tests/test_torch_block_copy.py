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
