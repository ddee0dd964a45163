"""The port's sampling (dynamo_tpu_torch/engine/sampling.py) against the JAX
package's engine/sampling.py on the same float32 logits.

Greedy, penalties, masks and logprobs must agree to float32 rounding
(tolerance 1e-5 on values; token ids exactly). The port's seeded Gumbel
noise is JAX's (threefry keyed by fold_in(PRNGKey(seed), step)), held to
``jax.random.gumbel`` row by row at 1e-6 (the two logs round apart by an
ulp or so). The sampled paths are compared with the SAME noise fed to
both, so that their masking and argmax are tested apart from the noise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import sampling as js
from dynamo_tpu_torch.engine import sampling as ts

TOL = 1e-5
B, V = 5, 64


def _logits(seed=0):
    return np.random.default_rng(seed).standard_normal((B, V)).astype(np.float32) * 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_greedy_matches_jax_including_ties():
    l = _logits()
    l[2, 10] = l[2, 40] = l[2].max() + 1.0   # a tie: first index wins in both
    zeros = np.zeros(B, np.float32)
    want = js.sample_tokens(
        jnp.asarray(l), jnp.zeros(B, jnp.uint32), jnp.zeros(B, jnp.int32),
        jnp.asarray(zeros), jnp.zeros(B, jnp.int32), jnp.ones(B, jnp.float32),
    )
    got = ts.sample_tokens(_t(l), _t(zeros), torch.zeros(B, dtype=torch.long),
                           torch.ones(B))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[2]) == 10


PENALTIES = {
    "presence": (0.7, 0.0, 1.0),
    "frequency": (0.0, 0.45, 1.0),
    "repetition": (0.0, 0.0, 1.3),
    "all": (0.5, -0.2, 0.8),
}


@pytest.mark.parametrize("name", sorted(PENALTIES))
def test_penalties_match_jax(name):
    pres, freq, rep = PENALTIES[name]
    rng = np.random.default_rng(1)
    l = _logits(1)
    counts = rng.integers(0, 3, size=(B, V)).astype(np.int32)
    mask = (rng.random((B, V)) < 0.2).astype(np.int8)
    vec = [np.full(B, x, np.float32) for x in (pres, freq, rep)]
    want = js.apply_penalties(jnp.asarray(l), jnp.asarray(counts), jnp.asarray(mask),
                              *map(jnp.asarray, vec))
    got = ts.apply_penalties(_t(l), _t(counts), _t(mask), *map(_t, vec))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.6), (12, 0.3), (-1, 0.95)])
def test_topk_topp_mask_matches_jax(top_k, top_p):
    l = _logits(2)
    temp = np.full((B, 1), 0.7, np.float32)
    k = np.full(B, top_k, np.int32)
    p = np.full(B, top_p, np.float32)
    want = js._mask_topk_topp(jnp.asarray(l), jnp.asarray(temp), jnp.asarray(k), jnp.asarray(p))
    got = ts.mask_topk_topp(_t(l), _t(temp), _t(k), _t(p))
    np.testing.assert_array_equal(got.numpy() > -1e29, np.asarray(want) > -1e29)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_disabled_filters_keep_every_token():
    """top_k <= 0 and top_p >= 1 keep the whole vocabulary, whatever the
    rounding of the cumulative mass."""
    l = _logits(2)
    got = ts.mask_topk_topp(_t(l), torch.full((B, 1), 0.7),
                            torch.full((B,), -1), torch.ones(B))
    torch.testing.assert_close(got, _t(l), rtol=0, atol=0)


@pytest.fixture
def shared_noise(monkeypatch):
    """Make the JAX sampler draw row b's noise from a table: with seeds =
    arange(B) and the key chain reduced to PRNGKey(seed), row b's key holds
    b, which indexes the table. Returns the table."""
    noise = np.random.default_rng(3).gumbel(size=(B, V)).astype(np.float32)
    table = jnp.asarray(noise)
    monkeypatch.setattr(jax.random, "fold_in", lambda key, step: key)
    monkeypatch.setattr(
        jax.random, "gumbel",
        lambda key, shape, dtype=jnp.float32: table[key[1].astype(jnp.int32)],
    )
    return noise


SAMPLED = {
    "temperature": dict(temp=[0.8, 1.0, 0.0, 1.5, 0.3]),
    "top_k": dict(temp=[1.0] * B, top_k=[3, 1, 0, 8, 5]),
    "top_p": dict(temp=[0.9] * B, top_p=[0.5, 0.9, 1.0, 0.2, 0.7]),
    "min_p": dict(temp=[1.0] * B, min_p=[0.1, 0.0, 0.5, 0.05, 0.9]),
    "mixed": dict(temp=[0.0, 1.2, 0.7, 0.0, 2.0], top_k=[0, 4, 0, 3, 10],
                  top_p=[1.0, 0.8, 0.6, 1.0, 0.95], min_p=[0.0, 0.0, 0.2, 0.0, 0.01]),
}


@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_sampled_paths_match_jax_with_the_same_noise(case, shared_noise):
    c = SAMPLED[case]
    l = _logits(4)
    temp = np.asarray(c["temp"], np.float32)
    top_k = np.asarray(c.get("top_k", [0] * B), np.int32)
    top_p = np.asarray(c.get("top_p", [1.0] * B), np.float32)
    min_p = np.asarray(c.get("min_p", [0.0] * B), np.float32)
    want = js.sample_tokens(
        jnp.asarray(l), jnp.arange(B, dtype=jnp.uint32), jnp.zeros(B, jnp.int32),
        jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p), jnp.asarray(min_p),
    )
    got = ts.sample_tokens(_t(l), _t(temp), _t(top_k), _t(top_p), _t(min_p),
                           gumbel=_t(shared_noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_logprobs_match_jax():
    l = _logits(5)
    toks = np.asarray([3, 0, 63, 17, 8], np.int32)
    want = js.logprobs_of(jnp.asarray(l), jnp.asarray(toks))
    got = ts.logprobs_of(_t(l), _t(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_top_logprobs_match_jax():
    l = _logits(6)
    wv, wi = js.top_logprobs(jnp.asarray(l), jnp.bool_(True))
    gv, gi = ts.top_logprobs(_t(l))
    assert gv.shape == (B, ts.TOP_LOGPROBS_K)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_allclose(gv.numpy(), np.asarray(wv), atol=TOL, rtol=TOL)


def test_update_counts_matches_jax():
    rng = np.random.default_rng(7)
    counts = rng.integers(0, 2, size=(B, V)).astype(np.int32)
    toks = np.asarray([1, 1, 5, 63, 0], np.int32)
    active = np.asarray([True, False, True, True, False])
    want = js.update_counts(jnp.asarray(counts), jnp.asarray(toks), jnp.asarray(active),
                            jnp.bool_(True))
    got = ts.update_counts(_t(counts.copy()), _t(toks), _t(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_seeded_stream_is_independent_of_the_batch():
    """Row noise depends on (seed, step) only: the same request draws the
    same numbers alone, in another batch position, or beside other rows;
    another step or seed draws other numbers."""
    alone = ts.gumbel_noise([42], [3], V, "cpu")[0]
    batched = ts.gumbel_noise([7, 9, 42], [0, 5, 3], V, "cpu")
    torch.testing.assert_close(batched[2], alone, rtol=0, atol=0)
    assert not torch.equal(ts.gumbel_noise([42], [4], V, "cpu")[0], alone)
    assert not torch.equal(ts.gumbel_noise([43], [3], V, "cpu")[0], alone)
    skipped = ts.gumbel_noise([42, 1], [3, 0], V, "cpu", rows=[True, False])
    torch.testing.assert_close(skipped[0], alone, rtol=0, atol=0)
    assert torch.count_nonzero(skipped[1]) == 0


def test_gumbel_noise_has_the_gumbel_distribution():
    """Mean ~ Euler-Mascheroni 0.5772, variance ~ pi^2 / 6."""
    g = ts.gumbel_noise(list(range(8)), [0] * 8, 20000, "cpu")
    assert abs(g.mean().item() - 0.5772) < 0.02
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.05


@pytest.mark.parametrize("seeds,steps", [
    ([7, 0, 4294967295, 123456789], [3, 0, 17, 1000]),
    ([2**32 + 5, 1], [0, 2**31 - 1]),     # seeds and steps key as uint32
])
def test_gumbel_noise_is_jax_threefry_gumbel(seeds, steps):
    """Row b equals jax.random.gumbel(fold_in(PRNGKey(uint32(seed)), step))."""
    vocab = 1000
    got = ts.gumbel_noise(seeds, steps, vocab, "cpu").numpy()
    for b, (seed, step) in enumerate(zip(seeds, steps)):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed % 2**32)), np.int32(step))
        want = np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32))
        np.testing.assert_allclose(got[b], want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seeds,steps", [
    ([7, 0, 4294967295, 123456789], [3, 0, 17, 1000]),
    ([2**32 + 5, 1], [0, 2**31 - 1]),     # seeds and steps key as uint32
])
def test_gumbel_noise_tensor_is_jax_threefry_gumbel(seeds, steps):
    """The decode horizon's form (device tensors in, every row drawn, the
    greedy rows zeroed by a where) equals the list form bit for bit, and
    row b jax.random.gumbel(fold_in(PRNGKey(uint32(seed)), step))."""
    vocab = 1000
    rows = [b % 2 == 0 for b in range(len(seeds))]
    got = ts.gumbel_noise_tensor(torch.tensor(seeds, dtype=torch.int64),
                                 torch.tensor(steps, dtype=torch.int64), vocab,
                                 rows=torch.tensor(rows))
    torch.testing.assert_close(got, ts.gumbel_noise(seeds, steps, vocab, "cpu", rows=rows),
                               rtol=0, atol=0)
    every = ts.gumbel_noise_tensor(torch.tensor(seeds, dtype=torch.int64),
                                   torch.tensor(steps, dtype=torch.int64), vocab).numpy()
    for b, (seed, step) in enumerate(zip(seeds, steps)):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed % 2**32)), np.int32(step))
        want = np.asarray(jax.random.gumbel(key, (vocab,), jnp.float32))
        np.testing.assert_allclose(every[b], want, rtol=1e-6, atol=1e-6)


def test_unfiltered_rows_pass_the_top_k_top_p_mask_unchanged():
    """sample_tokens(filtered=True) on rows with both filters off equals
    filtered=False: the flag only skips the sort when no row filters."""
    l = _logits(3)
    temp = np.full(B, 0.7, np.float32)
    noise = ts.gumbel_noise(list(range(B)), [2] * B, V, "cpu")
    args = (_t(l), _t(temp), torch.zeros(B, dtype=torch.long), torch.ones(B),
            torch.zeros(B), noise)
    assert torch.equal(ts.sample_tokens(*args, filtered=True),
                       ts.sample_tokens(*args, filtered=False))
    masked = ts.mask_topk_topp(_t(l), _t(temp)[:, None], torch.zeros(B, dtype=torch.long),
                               torch.ones(B))
    assert torch.equal(masked, _t(l))
