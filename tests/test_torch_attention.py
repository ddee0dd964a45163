"""The port's attention ops (dynamo_tpu_torch/ops) against the JAX package.

Every plain op is held to its twin in dynamo_tpu/ops/attention.py on the
same float32 inputs (made with numpy from a seed): tolerance 2e-5, the
float32 reference tolerance the JAX package's own tests use. Each CUDA
kernel's plain version (what its wrapper runs on CPU tensors) is also held
to the Pallas kernel it replaces, run in interpret mode as
tests/test_pallas_ops.py and tests/test_unified_attention.py run it:
tolerance 5e-5, looser because the Pallas kernels sum in chunks with an
online softmax while the plain versions take one dense softmax.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import pallas_prefill as pf
from dynamo_tpu.ops import pallas_unified as pun
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified

REF_TOL = 2e-5      # float32 plain op vs float32 JAX reference
KERNEL_TOL = 5e-5   # plain version vs Pallas interpret (other summation order)


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32), atol=tol, rtol=tol
    )


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _paged_case(rng, lens, h, kvh, d, bs, num_blocks, max_blocks):
    """Ragged rows over scrambled distinct pages; table padding points at
    scratch block 0."""
    B = len(lens)
    q = rng.standard_normal((B, h, d)).astype(np.float32)
    kc = rng.standard_normal((num_blocks, bs, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((num_blocks, bs, kvh, d)).astype(np.float32)
    tables = np.zeros((B, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for b, n_tok in enumerate(lens):
        for j in range(-(-int(n_tok) // bs)):
            tables[b, j] = free.pop()
    return q, kc, vc, tables, np.asarray(lens, np.int32)


def _ragged_case(rng, rows, h=8, kvh=2, d=16, bs=8, num_blocks=64, max_blocks=8,
                 gap=3):
    """rows: [(q_len, seq_len)]; segments packed in order with ``gap``
    padding tokens between them."""
    starts, pos = [], 0
    for ql, _ in rows:
        starts.append(pos)
        pos += ql + gap
    Tq = pos
    q = rng.standard_normal((Tq, h, d)).astype(np.float32)
    _, kc, vc, tables, lens = _paged_case(
        rng, [sl for _, sl in rows], h, kvh, d, bs, num_blocks, max_blocks
    )
    qlens = np.asarray([ql for ql, _ in rows], np.int32)
    return q, kc, vc, tables, np.asarray(starts, np.int32), qlens, lens


# ---------------------------------------------------------------- plain ops
def test_causal_attention_matches_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((10, 4, 8)).astype(np.float32)
    k = rng.standard_normal((10, 2, 8)).astype(np.float32)
    v = rng.standard_normal((10, 2, 8)).astype(np.float32)
    want = jatt.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    _close(tatt.causal_attention(_t(q), _t(k), _t(v)), want, REF_TOL)


@pytest.mark.parametrize("start,total", [(0, 12), (9, 21), (30, 36)])
def test_extend_attention_matches_jax(start, total):
    """First chunk, prefix continuation, and a short chunk against a long
    prefix; the context is padded past total_len (masked keys)."""
    rng = np.random.default_rng(1)
    S, T, h, kvh, d = total - start, 48, 8, 2, 16
    q = rng.standard_normal((S, h, d)).astype(np.float32)
    k = rng.standard_normal((T, kvh, d)).astype(np.float32)
    v = rng.standard_normal((T, kvh, d)).astype(np.float32)
    pos = np.arange(start, total, dtype=np.int32)
    want = jatt.extend_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pos), jnp.int32(total)
    )
    got = tatt.extend_attention(_t(q), _t(k), _t(v), _t(pos), total)
    _close(got, want, REF_TOL)


def test_gather_kv_matches_jax():
    rng = np.random.default_rng(2)
    kc = rng.standard_normal((16, 4, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((16, 4, 2, 8)).astype(np.float32)
    table = np.asarray([5, 2, 11, 0, 0], np.int32)
    wk, wv = jatt.gather_kv(jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(table))
    gk, gv = tatt.gather_kv(_t(kc), _t(vc), _t(table))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


@pytest.mark.parametrize("lens", [[1, 17, 33, 40], [7, 0, 24]])
def test_paged_decode_matches_jax(lens):
    """Ragged rows (not multiples of the block), padded tables, and an
    empty row (seq_len 0, which both plain versions handle alike)."""
    rng = np.random.default_rng(3)
    q, kc, vc, tables, sl = _paged_case(rng, lens, 8, 2, 16, 8, 32, 6)
    want = jatt.paged_decode_attention(*map(jnp.asarray, (q, kc, vc, tables, sl)))
    got = tatt.paged_decode_attention(*map(_t, (q, kc, vc, tables, sl)))
    _close(got, want, REF_TOL)


def test_write_prefill_kv_matches_jax():
    rng = np.random.default_rng(4)
    kc = rng.standard_normal((8, 4, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((8, 4, 2, 8)).astype(np.float32)
    kn = rng.standard_normal((12, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((12, 2, 8)).astype(np.float32)
    ids = np.asarray([6, 3, 0], np.int32)
    wk, wv = jatt.write_prefill_kv(*map(jnp.asarray, (kc, vc, kn, vn, ids)))
    gk, gv = tatt.write_prefill_kv(*map(_t, (kc.copy(), vc.copy(), kn, vn, ids)))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_write_decode_kv_matches_jax():
    rng = np.random.default_rng(5)
    kc = rng.standard_normal((8, 4, 2, 8)).astype(np.float32)
    vc = rng.standard_normal((8, 4, 2, 8)).astype(np.float32)
    kn = rng.standard_normal((3, 2, 8)).astype(np.float32)
    vn = rng.standard_normal((3, 2, 8)).astype(np.float32)
    ids = np.asarray([5, 1, 7], np.int32)
    offs = np.asarray([3, 0, 2], np.int32)
    wk, wv = jatt.write_decode_kv(*map(jnp.asarray, (kc, vc, kn, vn, ids, offs)))
    gk, gv = tatt.write_decode_kv(*map(_t, (kc.copy(), vc.copy(), kn, vn, ids, offs)))
    np.testing.assert_array_equal(gk.numpy(), np.asarray(wk))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


RAGGED_ROWS = {
    # a prefill segment continuing a prefix, decode rows, an empty row
    "mixed": [(13, 29), (1, 9), (0, 5), (1, 40), (1, 1)],
    "prefill_only": [(20, 20), (6, 31)],
    "decode_only": [(1, 3), (1, 17), (1, 64)],
    "empty_rows": [(0, 0), (5, 12), (0, 7)],
}


@pytest.mark.parametrize("case", sorted(RAGGED_ROWS))
def test_ragged_paged_attention_matches_jax(case):
    rng = np.random.default_rng(6)
    args = _ragged_case(rng, RAGGED_ROWS[case])
    want = jatt.ragged_paged_attention(*map(jnp.asarray, args))
    got = tatt.ragged_paged_attention(*map(_t, args))
    _close(got, want, REF_TOL)


def test_unported_extras_raise():
    """window/sinks/softcap come with a later slice: refused, never ignored."""
    q = torch.zeros(4, 2, 8)
    k = torch.zeros(4, 1, 8)
    with pytest.raises(NotImplementedError):
        tatt.causal_attention(q, k, k, window=2)
    with pytest.raises(NotImplementedError):
        tatt.extend_attention(q, k, k, torch.arange(4), 4, softcap=30.0)
    with pytest.raises(NotImplementedError):
        tatt.paged_decode_attention(
            q, torch.zeros(2, 4, 1, 8), torch.zeros(2, 4, 1, 8),
            torch.zeros(4, 1, dtype=torch.int32), torch.ones(4, dtype=torch.int32),
            sinks=torch.zeros(2),
        )


# ------------------------------------------- kernel plain versions vs Pallas
@pytest.mark.parametrize("chunk_tokens", [16, 32])
@pytest.mark.parametrize("lens", [[5, 16, 47], [1, 2, 33, 48]])
def test_decode_plain_matches_pallas_interpret(chunk_tokens, lens):
    rng = np.random.default_rng(7)
    q, kc, vc, tables, sl = _paged_case(rng, lens, 8, 2, 32, 16, 32, 3)
    want = pa.paged_decode_attention(
        *map(jnp.asarray, (q, kc, vc, tables, sl)),
        chunk_tokens=chunk_tokens, interpret=True,
    )
    got = cuda_attention.paged_decode_attention(*map(_t, (q, kc, vc, tables, sl)))
    _close(got, want, KERNEL_TOL)


@pytest.mark.parametrize("start,total", [(0, 128), (100, 228)])
def test_flash_extend_plain_matches_pallas_interpret(start, total):
    """First chunk and a prefix continuation with padded tail keys."""
    rng = np.random.default_rng(8)
    S, T, h, kvh, d = 128, 256, 8, 2, 32
    q = rng.standard_normal((S, h, d)).astype(np.float32)
    k = rng.standard_normal((T, kvh, d)).astype(np.float32)
    v = rng.standard_normal((T, kvh, d)).astype(np.float32)
    pos = jnp.arange(start, start + S, dtype=jnp.int32)
    want = pf.flash_extend_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), pos, jnp.int32(total),
        q_tile=64, kv_tile=64, interpret=True,
    )
    got = cuda_prefill.flash_extend_attention(_t(q), _t(k), _t(v), start, total)
    _close(got, want, KERNEL_TOL)


@pytest.mark.parametrize("case", sorted(RAGGED_ROWS))
def test_unified_plain_matches_pallas_interpret(case):
    rng = np.random.default_rng(9)
    args = _ragged_case(rng, RAGGED_ROWS[case])
    want = pun.ragged_paged_attention(
        *map(jnp.asarray, args), q_seg=4, chunk_tokens=32, interpret=True
    )
    got = cuda_unified.ragged_paged_attention(*map(_t, args))
    _close(got, want, KERNEL_TOL)


def test_kernel_argument_check_refuses_host_tensors():
    """The validator every wrapper runs before a launch refuses a tensor
    that does not lie on the card (the wrappers route CPU tensors to the
    plain version before it, so this is its only way in here)."""
    from dynamo_tpu_torch.ops._build import check_cuda_tensor

    with pytest.raises(ValueError, match="CUDA"):
        check_cuda_tensor("q", torch.zeros(2, 2, 128, dtype=torch.bfloat16),
                          torch.bfloat16, 3)
