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


# ------------------------------------------ window / sinks / softcap
# The attention attributes of the gemma and gpt-oss families, each alone and
# all at once, on every plain op against its JAX twin.
ATTRS = {
    "window": dict(window=7),
    "sinks": dict(sinks=True),
    "softcap": dict(softcap=5.0),
    "all": dict(window=5, sinks=True, softcap=5.0),
}


def _attrs(name, rng, h, jax_side):
    """The attribute kwargs of ATTRS[name] for one side: sinks [h] made
    with numpy from ``rng``, as a jax or a torch array."""
    kw = dict(ATTRS[name])
    if kw.pop("sinks", False):
        sinks = rng.standard_normal(h).astype(np.float32)
        kw["sinks"] = jnp.asarray(sinks) if jax_side else _t(sinks)
    return kw


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_causal_attention_attributes_match_jax(name):
    rng = np.random.default_rng(20)
    q = 2 * rng.standard_normal((14, 4, 8)).astype(np.float32)
    k = 2 * rng.standard_normal((14, 2, 8)).astype(np.float32)
    v = rng.standard_normal((14, 2, 8)).astype(np.float32)
    jkw = _attrs(name, np.random.default_rng(1), 4, True)
    tkw = _attrs(name, np.random.default_rng(1), 4, False)
    want = jatt.causal_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **jkw)
    _close(tatt.causal_attention(_t(q), _t(k), _t(v), **tkw), want, REF_TOL)


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_extend_attention_attributes_match_jax(name):
    """A continuation chunk over a prefix longer than the window, with the
    context padded past total_len."""
    rng = np.random.default_rng(21)
    start, total, T, h, kvh, d = 17, 30, 40, 8, 2, 16
    q = 2 * rng.standard_normal((total - start, h, d)).astype(np.float32)
    k = 2 * rng.standard_normal((T, kvh, d)).astype(np.float32)
    v = rng.standard_normal((T, kvh, d)).astype(np.float32)
    pos = np.arange(start, total, dtype=np.int32)
    jkw = _attrs(name, np.random.default_rng(2), h, True)
    tkw = _attrs(name, np.random.default_rng(2), h, False)
    want = jatt.extend_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 jnp.asarray(pos), jnp.int32(total), **jkw)
    got = tatt.extend_attention(_t(q), _t(k), _t(v), _t(pos), total, **tkw)
    _close(got, want, REF_TOL)


@pytest.mark.parametrize("name", sorted(ATTRS))
def test_paged_decode_attributes_match_jax(name):
    """Windowed rows gather only the trailing pages: rows shorter than the
    window, rows exactly w, w+1 and w+bs long, and rows several windows
    long (pages skipped)."""
    rng = np.random.default_rng(22)
    w = ATTRS[name].get("window", 0)
    lens = [1, 3, 33, 47] + ([w, w + 1, w + 8] if w else [9])
    q, kc, vc, tables, sl = _paged_case(rng, lens, 8, 2, 16, 8, 48, 7)
    jkw = _attrs(name, np.random.default_rng(3), 8, True)
    tkw = _attrs(name, np.random.default_rng(3), 8, False)
    want = jatt.paged_decode_attention(*map(jnp.asarray, (q, kc, vc, tables, sl)), **jkw)
    got = tatt.paged_decode_attention(*map(_t, (q, kc, vc, tables, sl)), **tkw)
    _close(got, want, REF_TOL)


@pytest.mark.parametrize("name", sorted(ATTRS))
@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_ragged_attributes_match_jax(name, per_row):
    """The scalar window (a model layer's form) and the per-row windows
    array (the kernel's form), on prefill segments and decode rows past
    the window."""
    rng = np.random.default_rng(23)
    rows = [(13, 29), (1, 9), (0, 5), (1, 40), (4, 21), (1, 1)]
    args = _ragged_case(rng, rows)
    jkw = _attrs(name, np.random.default_rng(4), 8, True)
    tkw = _attrs(name, np.random.default_rng(4), 8, False)
    if per_row and "window" in jkw:
        w = jkw.pop("window")
        tkw.pop("window")
        wins = np.asarray([w, 0, w, w + 3, 0, w], np.int32)
        jkw["windows"], tkw["windows"] = jnp.asarray(wins), _t(wins)
    want = jatt.ragged_paged_attention(*map(jnp.asarray, args), **jkw)
    got = tatt.ragged_paged_attention(*map(_t, args), **tkw)
    _close(got, want, REF_TOL)


@pytest.mark.parametrize("w", [8, 9, 16])
def test_window_edges_match_jax(w):
    """Off-by-one at the window edge: with bs 8, rows whose context is
    exactly w, w + 1 and w + bs long, decode rows and prefill segments,
    key j visible iff p - w < j <= p."""
    rng = np.random.default_rng(24)
    rows = [(1, w), (1, w + 1), (1, w + 8), (w, w), (3, w + 1), (5, w + 8)]
    args = _ragged_case(rng, rows)
    want = jatt.ragged_paged_attention(*map(jnp.asarray, args), window=w)
    got = tatt.ragged_paged_attention(*map(_t, args), window=w)
    _close(got, want, REF_TOL)
    full = tatt.ragged_paged_attention(*map(_t, args))
    assert not torch.allclose(got, full), "the window must cut some row"


def test_head_dim_256_plain_matches_jax():
    """Gemma's head_dim (256) with all three attributes on the plain ops."""
    rng = np.random.default_rng(25)
    args = _ragged_case(rng, [(9, 40), (1, 33), (1, 12)], h=8, kvh=4, d=256,
                        bs=16, num_blocks=16, max_blocks=3)
    sinks = rng.standard_normal(8).astype(np.float32)
    kw = dict(window=17, softcap=50.0)
    want = jatt.ragged_paged_attention(*map(jnp.asarray, args), sinks=jnp.asarray(sinks), **kw)
    got = tatt.ragged_paged_attention(*map(_t, args), sinks=_t(sinks), **kw)
    _close(got, want, REF_TOL)


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


# the attribute row mixes of tests/test_unified_attention.py (ATTR_CASES)
UNIFIED_ATTR_CASES = {
    "windowed_rows": dict(rows=[(12, 36), (1, 33), (0, 0), (1, 9)], windows=[7, 16, 0, 0]),
    "sink_rows": dict(rows=[(8, 24), (1, 17), (1, 5)], sinks=True),
    "softcap_rows": dict(rows=[(8, 24), (1, 17), (1, 5)], softcap=30.0),
    "window_sink_softcap": dict(rows=[(12, 20), (1, 33), (0, 0), (1, 9)],
                                windows=[6, 12, 0, 5], sinks=True, softcap=50.0),
    "verify_rows": dict(rows=[(4, 12), (4, 21), (0, 0), (1, 33)]),
    "verify_windowed": dict(rows=[(4, 36), (4, 21), (1, 17)], windows=[9, 0, 11]),
}
# bf16 outputs: the two sides round float32 results that differ in the
# last float32 bits to bf16 (8 significant bits): one bf16 step is 2^-8
# relative, so up to ~4e-3 on outputs of magnitude ~1
BF16_TOL = 8e-3


@pytest.mark.parametrize("case", sorted(UNIFIED_ATTR_CASES))
@pytest.mark.parametrize("kind", ["float32", "bf16", "int8"])
def test_unified_attributes_plain_matches_pallas_interpret(case, kind):
    """The unified wrapper's plain version with windows / sinks / softcap
    against the Pallas kernel in interpret mode, on float32, bf16 and
    int8 caches."""
    from dynamo_tpu.ops.quant import QuantizedKV as JQuantizedKV
    from dynamo_tpu.ops.quant import quantize_blocks as jquantize
    from dynamo_tpu_torch.ops.quant import QuantizedKV, quantize_blocks

    spec = UNIFIED_ATTR_CASES[case]
    rng = np.random.default_rng(10)
    q, kc, vc, tables, starts, qlens, lens = _ragged_case(
        rng, spec["rows"], h=8, kvh=4, d=32, bs=8, num_blocks=64, max_blocks=8)
    jkw, tkw = {}, {}
    if "windows" in spec:
        wins = np.asarray(spec["windows"], np.int32)
        jkw["windows"], tkw["windows"] = jnp.asarray(wins), _t(wins)
    if spec.get("sinks"):
        sinks = rng.standard_normal(8).astype(np.float32)
        jkw["sinks"], tkw["sinks"] = jnp.asarray(sinks), _t(sinks)
    if spec.get("softcap"):
        jkw["softcap"] = tkw["softcap"] = spec["softcap"]
    meta = (tables, starts, qlens, lens)
    if kind == "bf16":
        jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, kc, vc))
        tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, kc, vc))
    elif kind == "int8":
        jq, tq = jnp.asarray(q), _t(q)
        jk, jv = (JQuantizedKV(*jquantize(jnp.asarray(a))) for a in (kc, vc))
        tk, tv = (QuantizedKV(*quantize_blocks(_t(a))) for a in (kc, vc))
    else:
        jq, jk, jv = map(jnp.asarray, (q, kc, vc))
        tq, tk, tv = map(_t, (q, kc, vc))
    want = pun.ragged_paged_attention(jq, jk, jv, *map(jnp.asarray, meta), **jkw,
                                      q_seg=4, chunk_tokens=16, interpret=True)
    got = cuda_unified.ragged_paged_attention(tq, tk, tv, *map(_t, meta), **tkw)
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           BF16_TOL if kind == "bf16" else KERNEL_TOL)


def test_unified_wrapper_softcap_zero_is_off():
    """The wrapper's softcap 0 means no cap (the kernel's convention), and
    its per-row windows array equals the plain op's scalar window of the
    same bound."""
    rng = np.random.default_rng(11)
    args = [_t(a) for a in _ragged_case(rng, [(6, 20), (1, 17)])]
    plain = tatt.ragged_paged_attention(*args)
    assert torch.equal(cuda_unified.ragged_paged_attention(*args, softcap=0.0), plain)
    wins = torch.tensor([5, 5], dtype=torch.int32)
    assert torch.equal(tatt.ragged_paged_attention(*args, window=5),
                       cuda_unified.ragged_paged_attention(*args, windows=wins))


def test_kernel_argument_check_refuses_host_tensors():
    """The validator every wrapper runs before a launch refuses a tensor
    that does not lie on the card (the wrappers route CPU tensors to the
    plain version before it, so this is its only way in here)."""
    from dynamo_tpu_torch.ops._build import check_cuda_tensor

    with pytest.raises(ValueError, match="CUDA"):
        check_cuda_tensor("q", torch.zeros(2, 2, 128, dtype=torch.bfloat16),
                          torch.bfloat16, 3)
