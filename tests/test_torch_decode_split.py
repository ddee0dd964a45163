"""Split-K of the port's paged decode kernel, in its plain version.

The decode kernel (dynamo_tpu_torch/csrc/decode_attention.cu) cuts each
row's keys from key 0 into splits of DEC_SPLIT_KEYS keys
(``ops.attention.split_plan`` with the page size as the alignment), computes
each split's partial softmax state in its own block and merges them in the
same launch. ``ops.attention.split_paged_decode_attention`` is its plain
version; the GPU smoke script holds the kernel to it on the card. Here it
is held, on seeded numpy inputs, to the unsplit plain op, to the JAX
reference ``dynamo_tpu.ops.attention.paged_decode_attention`` and to the
Pallas kernel it replaces in interpret mode, on float32-held bf16 values
and on int8 caches, at splits of 1 and 2 pages and of DEC_SPLIT_KEYS, over
rows of 1 key, exactly one split, one split plus one key, and many splits.
Tolerances: 2e-5 against JAX and the unsplit op (float32 on both sides; the
merge sums the same terms in another order), 5e-5 against the Pallas
interpreter (its own chunked summation order), as in
tests/test_torch_attention.py.
"""

import asyncio
import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.ops import attention as jatt
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops.quant import QuantizedKV as JQuantizedKV
from dynamo_tpu.ops.quant import quantize_blocks as jquantize
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops import cuda_attention
from dynamo_tpu_torch.ops.quant import QuantizedKV, quantize_blocks
from dynamo_tpu_torch.runtime import Context

REF_TOL = 2e-5      # float32 split + merge vs the unsplit op and JAX
KERNEL_TOL = 5e-5   # vs the Pallas kernel in interpret mode
H, KVH, D, BS = 8, 2, 32, 8
DEC = cuda_attention.DEC_SPLIT_KEYS
# split sizes in keys: 1 page, 2 pages, the kernel's
SPLITS = (BS, 2 * BS, DEC)
# for every split size: a 1-key row, rows of exactly one split and one
# split plus a key, and a row of many splits
LENS = [1, BS, BS + 1, 2 * BS, 2 * BS + 1, DEC, DEC + 1, 700]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@functools.lru_cache(maxsize=None)
def _case(kind):
    """numpy q / k / v rounded to bf16 and held in float32, tables over
    scrambled distinct pages; then the torch and JAX caches of ``kind``
    ("bf16": the float32-held values, "int8": quantized) and the JAX
    reference's and the Pallas interpreter's outputs."""
    rng = np.random.default_rng(11)
    pages = sum(-(-n // BS) for n in LENS)
    nb, mb = pages + 8, -(-max(LENS) // BS) + 2

    def bf16(shape):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        return x.to(torch.bfloat16).float().numpy()

    q, kc, vc = bf16((len(LENS), H, D)), bf16((nb, BS, KVH, D)), bf16((nb, BS, KVH, D))
    tables = np.zeros((len(LENS), mb), np.int32)
    free = list(rng.permutation(np.arange(1, nb)))
    for r, n in enumerate(LENS):
        for j in range(-(-n // BS)):
            tables[r, j] = free.pop()
    lens = np.asarray(LENS, np.int32)
    if kind == "int8":
        jk, jv = (JQuantizedKV(*jquantize(jnp.asarray(a))) for a in (kc, vc))
        tk, tv = (QuantizedKV(*quantize_blocks(_t(a))) for a in (kc, vc))
    else:
        jk, jv, tk, tv = jnp.asarray(kc), jnp.asarray(vc), _t(kc), _t(vc)
    jmeta = (jnp.asarray(tables), jnp.asarray(lens))
    want_jax = np.asarray(jatt.paged_decode_attention(jnp.asarray(q), jk, jv, *jmeta))
    want_pallas = np.asarray(pa.paged_decode_attention(jnp.asarray(q), jk, jv, *jmeta,
                                                       chunk_tokens=64, interpret=True))
    return (_t(q), tk, tv, _t(tables), _t(lens)), want_jax, want_pallas


@pytest.mark.parametrize("split_keys", SPLITS)
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_split_decode_matches_unsplit_jax_and_pallas(kind, split_keys):
    targs, want_jax, want_pallas = _case(kind)
    got = tatt.split_paged_decode_attention(*targs, split_keys=split_keys)
    np.testing.assert_allclose(got.numpy(), tatt.paged_decode_attention(*targs).numpy(),
                               atol=REF_TOL, rtol=REF_TOL)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=REF_TOL, rtol=REF_TOL)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=KERNEL_TOL, rtol=KERNEL_TOL)
    # the split path ran: rows longer than one split were cut, the others not
    n = [tatt.split_plan(1, x, 0, split_keys, BS)[2] for x in LENS]
    assert [c >= 2 for c in n] == [x > split_keys for x in LENS]


@pytest.mark.parametrize("max_seq_len", [1, 200, 300, 699])
def test_a_bound_below_a_row_only_lengthens_its_splits(max_seq_len):
    """The grid's split extent S comes from the host bound; a bound below
    the longest row gives that row fewer, longer splits (at most S) and the
    same result."""
    targs, _, _ = _case("bf16")
    S = cuda_attention.split_extent(max_seq_len)
    got = tatt.split_paged_decode_attention(*targs, split_keys=DEC, max_splits=S)
    np.testing.assert_allclose(got.numpy(), tatt.paged_decode_attention(*targs).numpy(),
                               atol=REF_TOL, rtol=REF_TOL)
    for x in LENS:
        _, split, n = tatt.split_plan(1, x, 0, DEC, BS, S)
        assert n <= S and split % BS == 0 and (n == 0 or (n - 1) * split < x <= n * split)


def test_a_merge_without_each_rows_last_split_fails():
    """The mutant the GPU smoke script also runs: the plain merge with each
    split row's last split weighted 0 must move the split rows far past the
    tolerance."""
    q, kc, vc, tables, lens = _case("bf16")[0]
    B = len(LENS)
    starts, ones = torch.arange(B, dtype=torch.int32), torch.ones(B, dtype=torch.int32)
    acc, m, l, n = tatt.attention_partials(q, kc, vc, tables, starts, ones, lens,
                                           split_keys=2 * BS, align=BS)
    want = tatt.paged_decode_attention(q, kc, vc, tables, lens)
    split = [r for r, c in enumerate(n.tolist()) if c >= 2]
    assert split
    for r in split:
        l[r, n[r] - 1] = 0.0
    wrong = tatt.merge_attention_partials(acc, m, l, n, starts, ones, want.clone())
    moved = (wrong[split] - want[split]).abs().amax(dim=(1, 2))
    assert (moved > 100 * KERNEL_TOL).all(), moved


def test_cpu_wrapper_takes_and_ignores_max_seq_len():
    targs, _, _ = _case("int8")
    plain = tatt.paged_decode_attention(*targs)
    for bound in (None, 1, 700, 10_000):
        assert torch.equal(cuda_attention.paged_decode_attention(*targs, max_seq_len=bound),
                           plain)


def test_split_constant_and_plan_mirror_the_kernel():
    """DEC_SPLIT_KEYS here is the kernel's constant, and the plan of the
    llama check batch gives 208 working blocks (26 splits x 8 kv heads)
    on the H100's 132 SMs, against 64 unsplit."""
    src = os.path.join(os.path.dirname(cuda_attention.__file__), "..", "csrc",
                       "decode_attention.cu")
    with open(src) as f:
        assert re.search(r"constexpr int DEC_SPLIT_KEYS = (\d+);", f.read()).group(1) == str(DEC)
    lens = [1, 17, 250, 999, 2100, 513, 77, 1500]
    S = cuda_attention.split_extent(max(lens))
    n = [tatt.split_plan(1, x, 0, DEC, 16, S)[2] for x in lens]
    assert (S, n) == (9, [0, 0, 0, 4, 9, 3, 0, 6])
    assert 8 * sum(max(c, 1) for c in n) == 208
    assert cuda_attention.split_extent(DEC) == 1 and cuda_attention.split_extent(0) == 1


# ------------------------------------------------- the engine's bound
def test_engine_bounds_every_decode_call_by_its_rows(monkeypatch):
    """Every decode-kernel call of a TorchEngine(device="cpu") llama run
    passes a host ``max_seq_len`` at least each row's seq_len."""
    calls = []
    real = cuda_attention.paged_decode_attention

    def spy(q, kc, vc, tables, seq_lens, **kw):
        calls.append((seq_lens.tolist(), kw.get("max_seq_len")))
        return real(q, kc, vc, tables, seq_lens, **kw)

    monkeypatch.setattr(cuda_attention, "paged_decode_attention", spy)
    cfg = LlamaConfig(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
                      num_kv_heads=2, head_dim=16, intermediate_size=128,
                      dtype=torch.float32)
    engine = TorchEngine(TorchEngineConfig(
        model=cfg, device="cpu", num_blocks=96, block_size=4, max_batch_size=4,
        max_context=256, prefill_buckets=(16, 32, 64), seed=0, decode_steps=1,
        decode_pipeline=1))

    async def run(rid, n, max_tokens):
        req = PreprocessedRequest(
            request_id=rid, model="m",
            token_ids=np.random.default_rng(n).integers(0, 256, size=n).tolist(),
            stop=StopConditions(max_tokens=max_tokens),
            sampling=SamplingOptions(temperature=0.0))
        return sum([len(o.token_ids) async for o in engine.generate(req, Context())])

    async def main():
        return await asyncio.gather(run("a", 20, 12), run("b", 90, 8), run("c", 7, 10))

    try:
        assert asyncio.run(main()) == [12, 8, 10]
    finally:
        engine.stop()
    assert calls and engine.step_counts["decode"] > 0
    for seq_lens, bound in calls:
        assert bound is not None and bound >= max(seq_lens)
    # rows of several lengths shared decode steps
    assert any(len({x for x in s if x}) > 1 for s, _ in calls)
