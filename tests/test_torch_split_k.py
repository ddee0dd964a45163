"""Split-K of the port's unified attention kernel, in its plain versions.

The unified kernel (dynamo_tpu_torch/csrc/unified_attention.cu) cuts the
keys of a row that fits one q tile (decode rows, short segments) into
splits, writes each split's partial softmax state (m, l, unnormalized acc)
and merges them in a second kernel. ``ops.attention.attention_partials``,
``merge_attention_partials`` and ``split_ragged_paged_attention`` are the
plain versions of those steps; the GPU smoke script holds the kernels to
them on the card. Here the split computation is held to the unsplit plain
op and to the JAX reference ``dynamo_tpu.ops.attention.ragged_paged_attention``
on the same float32 inputs (numpy, seeded), at split sizes of 1, 2 and 3
pages: tolerance 2e-5, the float32 reference tolerance of
tests/test_torch_attention.py (the merge sums the same terms in another
order). The int8 algebra of the kernels' tile body, and the engine's
``max_seq_len`` bound, are checked at the end.
"""

import asyncio

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops.quant import QuantizedKV as JQuantizedKV
from dynamo_tpu.ops.quant import quantize_blocks as jquantize
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.gemma import GemmaConfig
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops import cuda_unified
from dynamo_tpu_torch.ops.quant import QuantizedKV, quantize_blocks
from dynamo_tpu_torch.runtime import Context

TOL = 2e-5          # float32 split + merge vs the unsplit op and JAX
H, KVH, D, BS = 8, 2, 16, 8   # G = 4: one q tile holds 16 tokens


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, rows, num_blocks=96, max_blocks=12, gap=2):
    """rows: [(q_len, seq_len, window)] packed ``gap`` tokens apart over
    scrambled distinct pages; returns numpy (q, kc, vc, tables, q_starts,
    q_lens, seq_lens, windows)."""
    rng = np.random.default_rng(seed)
    starts, pos = [], 0
    for ql, _, _ in rows:
        starts.append(pos)
        pos += ql + gap
    q = 2 * rng.standard_normal((pos, H, D)).astype(np.float32)
    kc = rng.standard_normal((num_blocks, BS, KVH, D)).astype(np.float32)
    vc = rng.standard_normal((num_blocks, BS, KVH, D)).astype(np.float32)
    tables = np.zeros((len(rows), max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for r, (_, sl, _) in enumerate(rows):
        for j in range(-(-sl // BS)):
            tables[r, j] = free.pop()
    i32 = lambda xs: np.asarray(xs, np.int32)  # noqa: E731
    return (q, kc, vc, tables, i32(starts), i32([r[0] for r in rows]),
            i32([r[1] for r in rows]), i32([r[2] for r in rows]))


# each case: rows (q_len, seq_len, window) and the attributes it carries
CASES = {
    # the 12-token row's earliest window starts at key 44: a one-page split
    # [40, 48) lies wholly below the windows of its tokens 4..11
    "windows": dict(rows=[(12, 60, 5), (1, 70, 9), (3, 33, 20), (1, 90, 0)], window=True),
    "sinks": dict(rows=[(1, 40, 0), (5, 64, 0), (1, 90, 30)], window=True, sinks=True),
    "softcap": dict(rows=[(1, 47, 0), (16, 80, 0), (2, 25, 0)], softcap=5.0),
    "int8": dict(rows=[(1, 50, 0), (7, 61, 11), (1, 88, 0)], window=True, int8=True,
                 sinks=True, softcap=5.0),
    "empty_rows": dict(rows=[(0, 0, 0), (1, 40, 0), (0, 33, 0), (1, 0, 0), (4, 37, 0)]),
    # segments longer than one q tile (16 tokens) are never split
    "long_prefill": dict(rows=[(40, 90, 0), (17, 30, 10), (1, 75, 0)], window=True),
}


def _inputs(name):
    case = CASES[name]
    q, kc, vc, tables, starts, qlens, lens, wins = _case(7, case["rows"])
    # sinks near the rows' largest scores, so their mass counts
    sinks = np.random.default_rng(8).standard_normal(H).astype(np.float32) + 3.0
    jkw, tkw = {}, {}
    if case.get("window"):
        jkw["windows"], tkw["windows"] = jnp.asarray(wins), _t(wins)
    if case.get("sinks"):
        jkw["sinks"], tkw["sinks"] = jnp.asarray(sinks), _t(sinks)
    if case.get("softcap"):
        jkw["softcap"] = tkw["softcap"] = case["softcap"]
    if case.get("int8"):
        jk, jv = (JQuantizedKV(*jquantize(jnp.asarray(a))) for a in (kc, vc))
        tk, tv = (QuantizedKV(*quantize_blocks(_t(a))) for a in (kc, vc))
    else:
        jk, jv, tk, tv = jnp.asarray(kc), jnp.asarray(vc), _t(kc), _t(vc)
    meta = (tables, starts, qlens, lens)
    jargs = (jnp.asarray(q), jk, jv, *map(jnp.asarray, meta))
    targs = (_t(q), tk, tv, *map(_t, meta))
    return jargs, jkw, targs, tkw


@pytest.mark.parametrize("split_pages", [1, 2, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_matches_unsplit_and_jax(name, split_pages):
    jargs, jkw, targs, tkw = _inputs(name)
    want = jatt.ragged_paged_attention(*jargs, **jkw)
    plain = tatt.ragged_paged_attention(*targs, **tkw)
    got = tatt.split_ragged_paged_attention(*targs, split_pages=split_pages, **tkw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=TOL, rtol=TOL)
    wins = tkw.get("windows")
    _, _, _, n = tatt.attention_partials(*targs, split_keys=split_pages * BS, align=BS,
                                         windows=wins)
    rows = CASES[name]["rows"]
    split_rows = [r for r, c in enumerate(n.tolist()) if c >= 2]
    # the split path ran wherever a one-tile row spans more than one split
    assert split_rows, n
    assert all(0 < rows[r][0] <= tatt.TILE_ROWS // (H // KVH) for r in split_rows)
    assert all(n[r] == 0 for r, (ql, sl, _) in enumerate(rows) if ql <= 0 or sl <= 0 or ql > 16)


def test_a_split_below_a_row_window_weighs_zero():
    """The one-page split [40, 48) of the 12-token windowed row: its
    tokens 4..11 see none of its keys (l = 0, m = NEG_INF), and the merge
    still equals the reference."""
    _, _, targs, tkw = _inputs("windows")
    acc, m, l, n = tatt.attention_partials(*targs, split_keys=BS, align=BS,
                                           windows=tkw["windows"])
    assert n[0] >= 2
    first, split, _ = tatt.split_plan(12, 60, 5, BS, BS)
    assert (first, split) == (40, BS)
    assert torch.all(l[0, 0, 4:12] == 0) and torch.all(m[0, 0, 4:12] == tatt.NEG_INF)
    assert torch.all(acc[0, 0, 4:12] == 0)
    assert torch.all(l[0, 0, :4] > 0)
    out = torch.zeros_like(targs[0])
    tatt.merge_attention_partials(acc, m, l, n, targs[4], targs[5], out)
    want = tatt.ragged_paged_attention(*targs, **tkw)
    np.testing.assert_allclose(out[:12].numpy(), want[:12].numpy(), atol=TOL, rtol=TOL)


def test_a_sink_counted_once_per_split_fails():
    """Seeding every split with the sink (l_s + exp(sink - m_s)) instead of
    the merge once must move the output far past the tolerance."""
    _, _, targs, tkw = _inputs("sinks")
    sinks = tkw["sinks"]
    acc, m, l, n = tatt.attention_partials(*targs, split_keys=BS, align=BS,
                                           windows=tkw["windows"])
    want = tatt.ragged_paged_attention(*targs, **tkw)
    right = tatt.merge_attention_partials(acc, m, l, n, targs[4], targs[5],
                                          torch.zeros_like(want), sinks)
    per_split = torch.where(l > 0, l + torch.exp(sinks - m), l)
    wrong = tatt.merge_attention_partials(acc, m, per_split, n, targs[4], targs[5],
                                          torch.zeros_like(want))
    split_tokens = [s + t for r, (s, c) in enumerate(zip(targs[4].tolist(), n.tolist()))
                    if c >= 2 for t in range(int(targs[5][r]))]
    assert split_tokens
    np.testing.assert_allclose(right[split_tokens].numpy(), want[split_tokens].numpy(),
                               atol=TOL, rtol=TOL)
    assert (wrong[split_tokens] - want[split_tokens]).abs().max() > 100 * TOL


@pytest.mark.parametrize("sink", [None, 2.0])
def test_merge_of_empty_splits_is_zero(sink):
    """A row whose splits all saw no key: zero output with or without a
    sink (the sink's mass has no value to weigh), never a NaN."""
    R, S, QS = 1, 3, 2
    acc = torch.zeros(R, S, QS, H, D)
    m = torch.full((R, S, QS, H), tatt.NEG_INF)
    l = torch.zeros(R, S, QS, H)
    sinks = None if sink is None else torch.full((H,), sink)
    out = tatt.merge_attention_partials(acc, m, l, torch.tensor([3], dtype=torch.int32),
                                        torch.tensor([1]), torch.tensor([2]),
                                        torch.full((4, H, D), 7.0), sinks)
    assert torch.equal(out[1:3], torch.zeros(2, H, D))
    assert torch.equal(out[0], torch.full((H, D), 7.0)) and torch.equal(out[3], out[0])


def test_merge_wrapper_runs_the_plain_merge_on_the_cpu():
    _, _, targs, tkw = _inputs("sinks")
    acc, m, l, n = tatt.attention_partials(*targs, split_keys=2 * BS, align=BS,
                                           windows=tkw["windows"])
    args = (acc, m, l, n, targs[4], targs[5])
    want = tatt.merge_attention_partials(*args, torch.zeros_like(targs[0]), tkw["sinks"])
    got = cuda_unified.merge_attention_partials(*args, torch.zeros_like(targs[0]),
                                                tkw["sinks"])
    assert torch.equal(got, want)


@pytest.mark.parametrize("seed", range(4))
def test_split_plan_covers_the_live_keys(seed):
    """Splits start at the first live key's page (or step), cover the keys
    up to seq_len with no gap, and stay within ``max_splits``: a bound
    below the row's length lengthens the splits instead."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        sl = int(rng.integers(1, 9000))
        ql = int(rng.integers(1, min(sl, 32) + 1))
        w = int(rng.choice([0, 40, 1024, 4096]))
        keys = int(rng.choice([64, 512]))
        cap = int(rng.choice([0, 1, 3, 16]))
        first, split, n = tatt.split_plan(ql, sl, w, keys, 64, cap or None)
        lo = max(sl - ql - w + 1, 0) if w > 0 else 0
        assert first <= lo < first + 64 and first % 64 == 0
        assert split >= keys and split % 64 == 0
        if n:
            assert first + (n - 1) * split < sl <= first + n * split
            assert not cap or n <= cap
        else:
            assert sl - first <= split


def test_split_plan_of_a_gemma_decode_batch_fills_the_card():
    """The plan the kernel follows (split_shape for the launch, split_plan
    per row, KEY_STEP-aligned SPLIT_KEYS splits): Gemma's serving decode
    batch (8 q_len = 1 rows of 316-8016 keys, window 4096, 4 kv heads)
    runs more working blocks than the H100's 132 SMs, against 32 without
    split-K; a bound of at most SPLIT_KEYS keys means no split extent."""
    rows = [(1, n + 16, 4096) for n in (300, 1500, 2600, 4100, 5200, 6000, 7000, 8000)]
    S, QS = cuda_unified.split_shape(8, 4, 1, 8016)
    assert (S, QS) == (16, 1)
    n = [tatt.split_plan(ql, sl, w, cuda_unified.SPLIT_KEYS, cuda_unified.KEY_STEP, S)[2]
         for ql, sl, w in rows]
    assert n == [0, 3, 6, 9, 9, 8, 9, 9]
    assert 4 * sum(c or 1 for c in n) == 216 and 4 * len(rows) == 32
    assert cuda_unified.split_shape(8, 4, 1, cuda_unified.SPLIT_KEYS) == (1, 1)


def test_wrapper_takes_the_bounds_on_the_cpu():
    _, _, targs, tkw = _inputs("windows")
    plain = tatt.ragged_paged_attention(*targs, **tkw)
    got = cuda_unified.ragged_paged_attention(*targs, max_q_len=12, max_seq_len=90, **tkw)
    assert torch.equal(got, plain)


# ------------------------------------------------------------ int8 algebra
def test_int8_payload_converts_to_bf16_exactly():
    vals = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(vals.to(torch.bfloat16).to(torch.int32), vals.to(torch.int32))


def test_int8_scales_on_score_and_probability_columns_equal_dequantize_first():
    """The tile body's int8 algebra: q . k_int * k_scale (the scale on the
    f32 score column) equals q . (k_int * k_scale), and sum_j (p_j *
    v_scale_j) v_int_j (the scale on the probability column, before the
    bf16 rounding) equals sum_j p_j (v_int_j * v_scale_j), within f32
    rounding (rtol 1e-5); rounding p * v_scale to bf16 costs at most one
    bf16 step of it (2^-8 relative)."""
    rng = np.random.default_rng(3)
    T, d = 64, 128
    q = torch.tensor(rng.standard_normal(d), dtype=torch.bfloat16).float()
    k8 = torch.tensor(rng.integers(-127, 128, (T, d)), dtype=torch.int8)
    v8 = torch.tensor(rng.integers(-127, 128, (T, d)), dtype=torch.int8)
    ks = torch.tensor(rng.uniform(1e-3, 5e-2, T), dtype=torch.float32)
    vs = torch.tensor(rng.uniform(1e-3, 5e-2, T), dtype=torch.float32)
    kb, vb = k8.to(torch.bfloat16).float(), v8.to(torch.bfloat16).float()
    scores = (kb @ q) * ks
    deq = (k8.float() * ks[:, None]) @ q
    np.testing.assert_allclose(scores.numpy(), deq.numpy(), rtol=1e-5, atol=1e-5)
    p = torch.softmax(scores / d ** 0.5, dim=0)
    scaled = p * vs
    out = scaled @ vb
    want = p @ (v8.float() * vs[:, None])
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-5, atol=1e-7)
    rounded = scaled.to(torch.bfloat16).float()
    assert ((rounded - scaled).abs() <= scaled.abs() * 2.0 ** -8).all()


# ------------------------------------------------- the engine's bound
def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


ENGINE = dict(num_blocks=160, block_size=4, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64), seed=0, decode_steps=1, decode_pipeline=1)


@pytest.mark.parametrize("family", ["llama", "tiny_gemma3"])
def test_engine_bounds_every_unified_call_by_its_rows(family, monkeypatch):
    """Every unified call of a TorchEngine(device="cpu") run, decode,
    prefill-chunk and mixed steps alike, passes a host ``max_seq_len`` at
    least each row's seq_len (and a ``max_q_len`` at least each q_len)."""
    calls = []
    real = cuda_unified.ragged_paged_attention

    def spy(q, kc, vc, tables, q_starts, q_lens, seq_lens, **kw):
        calls.append((q_lens.tolist(), seq_lens.tolist(), kw.get("max_q_len"),
                      kw.get("max_seq_len")))
        return real(q, kc, vc, tables, q_starts, q_lens, seq_lens, **kw)

    monkeypatch.setattr(cuda_unified, "ragged_paged_attention", spy)
    if family == "llama":
        cfg = LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                          num_kv_heads=2, head_dim=16, intermediate_size=128,
                          dtype=torch.float32)
    else:
        cfg = GemmaConfig.tiny_gemma3(num_layers=3)
    engine = TorchEngine(TorchEngineConfig(model=cfg, device="cpu", **ENGINE))

    async def run(rid, tokens, max_tokens, on_first=None):
        req = PreprocessedRequest(request_id=rid, model="m", token_ids=tokens,
                                  stop=StopConditions(max_tokens=max_tokens),
                                  sampling=SamplingOptions(temperature=0.0))
        n = 0
        async for out in engine.generate(req, Context()):
            n += len(out.token_ids)
            if n and on_first is not None:
                on_first.set()
        return n

    async def main():
        started = asyncio.Event()
        lead = asyncio.ensure_future(run("lead", _prompt(2, 20), 16, started))
        await started.wait()
        rest = await asyncio.gather(run("b", _prompt(3, 130), 6), run("c", _prompt(4, 40), 6))
        return [await lead] + rest

    try:
        assert asyncio.run(main()) == [16, 6, 6]
    finally:
        engine.stop()
    assert engine.step_counts["mixed"] > 0, engine.step_counts
    assert calls
    for q_lens, seq_lens, max_q, max_seq in calls:
        assert max_seq is not None and max_seq >= max(seq_lens)
        assert max_q is not None and max_q >= max(q_lens)
    # ragged calls of several rows (mixed steps) were among them
    assert any(len(q) > 1 and max(q) > 1 for q, _, _, _ in calls)
