"""The port's MLA family (dynamo_tpu_torch/models/mla.py) and its latent
attention wrapper (ops/cuda_mla.py) against the JAX package.

Weights come from the JAX package's ``init_params`` (tiny_mla,
tiny_mla_moe; float32), with the sigmoid router's zero-init balancing
bias perturbed, through numpy and ``engine.weights.params_from_numpy``;
inputs are made with numpy from a seed. Tolerances: router weights 1e-6
with identical expert ids; layers and logits 1e-5 (float32 products in
other orders); the absorbed attention against the JAX package's
uncompressed ``mla.reference_attention`` 2e-4 (the reference test's);
the latent attention's plain forms 2e-5 (float32, the split-K tests'
tolerance). TorchEngine serving these models: tests/test_torch_mla_engine.py.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import mla as jmla
from dynamo_tpu.models.llama import rms_norm as jrms_norm
from dynamo_tpu.models.llama import rope_cos_sin as jrope
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import mla as tmla
from dynamo_tpu_torch.models import registry
from dynamo_tpu_torch.models.llama import rope_cos_sin as trope
from dynamo_tpu_torch.ops import attention as tatt
from dynamo_tpu_torch.ops import cuda_mla

ROUTE_TOL = 1e-6
TOL = 1e-5
REF_TOL = 2e-4
SPLIT_TOL = 2e-5

CONFIGS = {
    "tiny_mla": {},
    "tiny_mla_moe": {},
    "tiny_mla_moe_full_rank_q": {"q_lora_rank": 0},
}


def _configs(name="tiny_mla", **kw):
    preset = "tiny_mla_moe" if name.startswith("tiny_mla_moe") else "tiny_mla"
    kw = {**CONFIGS.get(name, {}), **kw}
    return (getattr(jmla.MlaConfig, preset)(**kw), getattr(tmla.MlaConfig, preset)(**kw))


def _numpy_params(jcfg, seed):
    tree = jax.tree.map(np.asarray, jmla.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lp in tree["layers"]:
        if "router_bias" in lp:
            lp["router_bias"] = (0.2 * rng.standard_normal(lp["router_bias"].shape)).astype(
                np.float32)
    return tree


def _jattend(q, k, v, i):
    return jatt.causal_attention(q, k, v)


def _tattend(q, k, v, i):
    return tatt.causal_attention(q, k, v)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ------------------------------------------------------------------ router
ROUTERS = {
    # DeepSeek-V2-Lite's: softmax, raw top-k weights
    "softmax": dict(moe_scoring="softmax", norm_topk_prob=False, num_experts=8,
                    num_experts_per_tok=3),
    # V3's selection bias, normalised and scaled weights
    "sigmoid_bias": dict(moe_scoring="sigmoid", norm_topk_prob=True,
                         routed_scaling_factor=2.5, num_experts=8, num_experts_per_tok=3),
    # and its group-limited selection
    "sigmoid_groups": dict(moe_scoring="sigmoid", norm_topk_prob=True,
                           routed_scaling_factor=2.5, num_experts=16,
                           num_experts_per_tok=4, n_group=4, topk_group=2),
}


@pytest.mark.parametrize("kind", list(ROUTERS))
def test_route_matches_jax(kind):
    jcfg, tcfg = _configs("tiny_mla_moe", **ROUTERS[kind])
    rng = np.random.default_rng(1)
    E = jcfg.num_experts
    p = {"w_router": rng.standard_normal((128, E)).astype(np.float32) / 4}
    if kind != "softmax":
        p["router_bias"] = (0.3 * rng.standard_normal(E)).astype(np.float32)
    x = rng.standard_normal((41, 128)).astype(np.float32)
    jw, ji = jmla.route(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    tw, ti = tmla.route({k: torch.from_numpy(a) for k, a in p.items()}, tcfg,
                        torch.from_numpy(x))
    assert ti.tolist() == np.asarray(ji).tolist()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_TOL, atol=ROUTE_TOL)


@pytest.mark.parametrize("groups", [False, True])
def test_route_breaks_ties_as_jax_top_k(groups):
    """A zero router scores every expert 0.5 (sigmoid): the bias alone
    decides, and its repeated values tie experts and groups; ties go to
    the lower id, as jax.lax.top_k breaks them."""
    kw = ROUTERS["sigmoid_groups" if groups else "sigmoid_bias"]
    jcfg, tcfg = _configs("tiny_mla_moe", **kw)
    E = jcfg.num_experts
    bias = np.tile(np.array([0.1, 0.3, 0.1, 0.3], np.float32), E // 4)
    p = {"w_router": np.zeros((128, E), np.float32), "router_bias": bias}
    x = np.random.default_rng(2).standard_normal((5, 128)).astype(np.float32)
    jw, ji = jmla.route(jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x))
    tw, ti = tmla.route({k: torch.from_numpy(a) for k, a in p.items()}, tcfg,
                        torch.from_numpy(x))
    assert ti.tolist() == np.asarray(ji).tolist()
    assert ti[0].tolist() == ([1, 3, 5, 7] if groups else [1, 3, 5])
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=ROUTE_TOL, atol=ROUTE_TOL)


# ---------------------------------------------------------------- model
def _rope(cfg, n, module):
    pos = np.arange(n, dtype=np.int32)
    if module == "jax":
        c, s = jrope(jnp.asarray(pos), cfg.qk_rope_head_dim, cfg.rope_theta)
    else:
        c, s = trope(torch.from_numpy(pos), cfg.qk_rope_head_dim, cfg.rope_theta)
    return c[:, None], s[:, None]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layer_forward_matches_jax(name):
    jcfg, tcfg = _configs(name)
    tree = _numpy_params(jcfg, seed=3)
    x = np.random.default_rng(4).standard_normal((20, 128)).astype(np.float32)
    tp = params_from_numpy(tree, tcfg, device="cpu")
    for i in range(jcfg.num_layers):
        want = jmla.layer_forward(jax.tree.map(jnp.asarray, tree["layers"][i]), jcfg,
                                  jnp.asarray(x), *_rope(jcfg, 20, "jax"), _jattend, i)
        got = tmla.layer_forward(tp["layers"][i], tcfg, torch.from_numpy(x),
                                 *_rope(tcfg, 20, "torch"), _tattend, i)
        _close(got.numpy(), want)


@pytest.mark.parametrize("q_lora_rank", [0, 96])
def test_absorbed_attention_matches_the_reference_attention(q_lora_rank):
    """The absorbed MQA-over-latent attention delta of the port's layer
    (its dense FFN zeroed) against the JAX package's uncompressed per-head
    attention."""
    jcfg, tcfg = _configs("tiny_mla", q_lora_rank=q_lora_rank)
    tree = _numpy_params(jcfg, seed=5)
    S = 24
    x = np.random.default_rng(6).standard_normal((S, 128)).astype(np.float32)
    jp = jax.tree.map(jnp.asarray, tree["layers"][0])
    h = jrms_norm(jnp.asarray(x), jp["attn_norm"], jcfg.rms_norm_eps)
    want = jmla.reference_attention(jp, jcfg, h, jnp.arange(S, dtype=jnp.int32))
    tp = params_from_numpy(tree, tcfg, device="cpu")["layers"][0]
    tp["w_down"] = torch.zeros_like(tp["w_down"])
    got = tmla.layer_forward(tp, tcfg, torch.from_numpy(x), *_rope(tcfg, S, "torch"),
                             _tattend, 0) - torch.from_numpy(x)
    _close(got.numpy(), want, REF_TOL)


@pytest.mark.parametrize("name", ["tiny_mla", "tiny_mla_moe"])
def test_logits_match_jax(name):
    jcfg, tcfg = _configs(name)
    tree = _numpy_params(jcfg, seed=7)
    tokens = np.random.default_rng(8).integers(0, 512, size=30).astype(np.int32)
    positions = np.arange(30, dtype=np.int32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jh = jmla.forward(jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions), _jattend)
    want = np.asarray(jmla.lm_logits(jparams, jcfg, jh))
    tparams = params_from_numpy(tree, tcfg, device="cpu")
    th = tmla.forward(tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
                      _tattend)
    _close(tmla.lm_logits(tparams, tcfg, th).numpy(), want)
    with pytest.raises(NotImplementedError, match="LoRA"):
        tmla.forward(tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
                     _tattend, lora=lambda *a: None)


def test_presets_and_registry_match_jax():
    fields = [f.name for f in dataclasses.fields(jmla.MlaConfig) if f.name != "dtype"]
    for fn in ("tiny_mla", "tiny_mla_moe", "deepseek_v2_lite", "deepseek_v3"):
        j, t = getattr(jmla.MlaConfig, fn)(), getattr(tmla.MlaConfig, fn)()
        for field in fields:
            assert getattr(j, field) == getattr(t, field), (fn, field)
        assert registry.PRESETS[fn.replace("_", "-")]() == t
    lite = tmla.MlaConfig.deepseek_v2_lite()
    assert (lite.num_kv_heads, lite.head_dim, lite.dtype) == (1, 576, torch.bfloat16)
    # a preset that tries to drift gets re-pinned
    drift = tmla.MlaConfig.tiny_mla(num_kv_heads=8, head_dim=999)
    assert (drift.num_kv_heads, drift.head_dim) == (1, 80)
    _, cfg = _configs("tiny_mla_moe")
    assert registry.is_mla(cfg) and not registry.is_moe(cfg)
    assert registry.family(cfg) is tmla
    assert registry.forward_fn(cfg) is tmla.forward
    assert registry.lm_logits_fn(cfg) is tmla.lm_logits
    keys = set()
    for kw in ({}, {"q_lora_rank": 0}):
        jcfg = jmla.MlaConfig.tiny_mla_moe(**kw)
        for i in range(jcfg.num_layers):
            keys |= set(jmla.init_layer_params(jax.random.PRNGKey(0), jcfg, i))
    assert set(registry.layer_keys(cfg)) == keys
    assert registry.float32_keys(cfg) == ("router_bias",)


def test_params_from_numpy_takes_dense_and_moe_layers_and_refuses_unknown_keys():
    jcfg, tcfg = _configs("tiny_mla_moe")
    tree = _numpy_params(jcfg, seed=9)
    params = params_from_numpy(tree, dataclasses.replace(tcfg, dtype=torch.bfloat16),
                               device="cpu")
    dense, sparse = params["layers"][0], params["layers"][1]
    assert "w_gate" in dense and "w_egate" not in dense
    assert sparse["w_egate"].shape == (4, 128, 64)
    assert sparse["router_bias"].dtype == torch.float32
    assert sparse["w_egate"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sparse["router_bias"].numpy(),
                                  tree["layers"][1]["router_bias"])
    tree["layers"][2]["sinks"] = np.zeros(4, np.float32)   # a gpt-oss key
    with pytest.raises(ValueError, match="sinks"):
        params_from_numpy(tree, tcfg, device="cpu")


# ------------------------------------------------------ latent attention
def _latent_case(seed, rows, h, d, bs=4, gap=3):
    """rows [(q_len, seq_len)] on scrambled distinct pages of a one-head
    cache; numpy (q, kv, tables, q_starts, q_lens, seq_lens), the values
    being the keys' first lanes."""
    rng = np.random.default_rng(seed)
    starts, pos = [], 0
    for ql, _ in rows:
        starts.append(pos)
        pos += ql + gap
    pages = [-(-sl // bs) for _, sl in rows]
    nb = sum(pages) + 3
    perm = 1 + rng.permutation(nb - 1)
    tables = np.zeros((len(rows), max(pages)), np.int32)
    used = 0
    for r, n in enumerate(pages):
        tables[r, :n] = perm[used:used + n]
        used += n
    q = rng.standard_normal((pos, h, d)).astype(np.float32)
    kv = rng.standard_normal((nb, bs, 1, d)).astype(np.float32)
    return (q, kv, tables, np.array(starts, np.int32),
            np.array([ql for ql, _ in rows], np.int32),
            np.array([sl for _, sl in rows], np.int32))


LATENT_ROWS = [(1, 37), (9, 40), (0, 12), (1, 1), (2, 21), (5, 5)]
LATENT_WIDTHS = pytest.mark.parametrize("h,d,v_dim", [(4, 80, 64), (16, 576, 512)],
                                        ids=["tiny_mla", "deepseek"])


@LATENT_WIDTHS
def test_latent_wrapper_on_cpu_is_jax_ragged_attention_cut_to_v_dim(h, d, v_dim):
    q, kv, *rows = _latent_case(10, LATENT_ROWS, h, d)
    want = np.asarray(jatt.ragged_paged_attention(
        *map(jnp.asarray, (q, kv, kv, *rows))))[..., :v_dim]
    got = cuda_mla.latent_paged_attention(*map(torch.from_numpy, (q, kv, *rows)), v_dim=v_dim)
    assert got.shape == want.shape
    _close(got.numpy(), want, SPLIT_TOL)


@LATENT_WIDTHS
def test_latent_wrapper_reads_values_from_the_model_cache_keys(h, d, v_dim):
    """The cache as the model builds it, K' = [c, k_pe] and V' = [c, 0]
    (c: v_dim latent lanes, k_pe: the rest): the wrapper over K' alone is
    the JAX package's ragged attention over (K', V') cut to v_dim."""
    q, c, *rows = _latent_case(12, LATENT_ROWS, h, v_dim)
    k_pe = np.random.default_rng(13).standard_normal(c.shape[:-1] + (d - v_dim,))
    k = np.concatenate([c, k_pe.astype(np.float32)], -1)
    v = np.concatenate([c, np.zeros_like(k_pe, np.float32)], -1)
    q = np.concatenate([q, np.random.default_rng(14).standard_normal(
        q.shape[:-1] + (d - v_dim,)).astype(np.float32)], -1)
    want = np.asarray(jatt.ragged_paged_attention(
        *map(jnp.asarray, (q, k, v, *rows))))[..., :v_dim]
    got = cuda_mla.latent_paged_attention(*map(torch.from_numpy, (q, k, *rows)), v_dim=v_dim)
    _close(got.numpy(), want, SPLIT_TOL)


def _split_case(h, rows, max_q):
    """split_latent_attention against the unsplit op on ``rows``, with the
    split counts of the plan; returns (the counts, the drop-last-split
    mutant's largest gap)."""
    args = tuple(map(torch.from_numpy, _latent_case(11, rows, h, 576, bs=16)))
    want = tatt.ragged_paged_attention(args[0], args[1], args[1], *args[2:])[..., :512]
    kw = dict(max_seq_len=max(sl for _, sl in rows), max_q_len=max_q)
    got = cuda_mla.split_latent_attention(*args, **kw)
    _close(got.numpy(), want.numpy(), SPLIT_TOL)
    _, _, qs, _ = cuda_mla.tile_shape(h, max_q)
    S = cuda_mla.split_extent(kw["max_seq_len"])
    _, _, _, n = tatt.attention_partials(args[0], args[1], args[1], *args[2:],
                                         split_keys=cuda_mla.SPLIT_KEYS, align=16,
                                         max_splits=S, tile_tokens=qs)
    plan = [tatt.split_plan(ql, sl, 0, cuda_mla.SPLIT_KEYS, 16, S)[2] if ql <= qs else 0
            for ql, sl in rows]
    assert n.tolist() == plan
    mutant = cuda_mla.split_latent_attention(*args, **kw, drop_last_split=True)
    return plan, float((mutant - want).abs().max())


@pytest.mark.parametrize("h", [16, 128])
def test_split_latent_attention_is_the_unsplit_op(h):
    """The kernel's split plan in plain PyTorch, wide form: decode rows
    (and, at G = 16, rows of 2-3 tokens, QS = 4) over a few 256-key
    splits, the last of which some tokens never reach (2 tokens, 513
    keys), equal the unsplit op; each row's split count follows
    att.split_plan; dropping each row's last split does not."""
    rows = [(1, 700), (2, 513), (1, 256), (3, 300), (1, 1), (1, 1030)]
    max_q = 4 if h == 16 else 1
    if h == 128:
        rows = [(1, 700), (1, 513), (1, 1), (1, 600)]
    assert cuda_mla.tile_shape(h, max_q)[0] == "wide"
    plan, gap = _split_case(h, rows, max_q)
    assert sum(c >= 2 for c in plan) >= (4 if h == 16 else 2) and gap > 0.1


def test_split_latent_attention_narrow_form():
    """The narrow form (G = 16, rows of at most 3 tokens: 48 pairs) may
    split every row (QS = 4, one wide tile's tokens); a 2-3 token row's
    splits take 2-3 16-row tiles each, and the first tokens of (2, 513)
    see no key of its last split."""
    rows = [(1, 700), (2, 513), (1, 256), (3, 300), (1, 1030)]
    assert cuda_mla.tile_shape(16, 3) == ("narrow", 16, 4, 4)
    plan, gap = _split_case(16, rows, 3)
    assert plan == [3, 3, 0, 2, 5] and gap > 0.1


@pytest.mark.parametrize("h", [16, 32, 48, 128])
def test_reserve_covers_every_launch_the_engine_makes(h):
    """The engine reserves the latent scratch for batch + 1 rows before
    its graphs are captured; every launch it makes (decode rows, a prefill
    chunk, the mixed step's chunk and decode rows), in either form, fits
    that reservation, so no eager launch grows (and frees) the buffer a
    graph captured."""
    B, L = 8, 8192
    counters, words = cuda_mla.reserve_words(B + 1, h, L)
    for rows in (1, B, B + 1):
        for q_len in (1, 2, 3, 4, 64, 2048):
            for seq in (1, 300, L):
                c, w = cuda_mla.scratch_words(rows, h, q_len, seq)
                assert c <= counters and w <= words, (rows, q_len, seq)


def test_tile_shapes_and_scratch():
    assert cuda_mla.tile_shape(16, 1) == ("narrow", 16, 4, 4)   # V2-Lite decode
    assert cuda_mla.tile_shape(16, 3) == ("narrow", 16, 4, 4)   # short rows
    assert cuda_mla.tile_shape(32, 1) == ("narrow", 16, 2, 4)
    assert cuda_mla.tile_shape(16, 4) == ("wide", 64, 4, 1)     # 64 pairs
    assert cuda_mla.tile_shape(16, 2048) == ("wide", 64, 4, 1)  # prefill / mixed
    assert cuda_mla.tile_shape(128, 1) == ("wide", 64, 1, 2)    # V2 / V3 decode
    assert cuda_mla.tile_shape(48, 1) == ("narrow", 16, 1, 3)
    assert cuda_mla.tile_shape(48, 2) == ("wide", 64, 1, 1)
    assert cuda_mla.split_extent(8192) == 32 and cuda_mla.split_extent(1) == 1
    assert cuda_mla.split_extent(10**6) == cuda_mla.MAX_SPLITS
    # the partials are the same in both forms; the narrow form has more
    # tile groups, so more counters
    words = 12 + 9 * 32 * 64 * (512 + 2)
    assert cuda_mla.scratch_words(9, 16, 1, 8192) == (36, words)
    assert cuda_mla.scratch_words(9, 16, 2048, 8192) == (9, words)
    assert cuda_mla.reserve_words(9, 16, 8192) == (36, words)
    assert cuda_mla.reserve_words(9, 32, 8192) == (36, words)
    assert cuda_mla.reserve_words(9, 128, 8192) == (18, 12 + 9 * 32 * 128 * (512 + 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_mla.latent_paged_attention(
            torch.zeros(1, 16, 576, dtype=torch.bfloat16, device="meta"),
            torch.zeros(2, 16, 1, 576, dtype=torch.bfloat16),
            *[torch.zeros(1, 1, dtype=torch.int32)] + [torch.zeros(1, dtype=torch.int32)] * 3)


def test_kernel_constants_mirror_the_source():
    """SPLIT_KEYS and the two forms' rows are the kernel's constants, the
    split cap fits the merge's shared memory, and the wrapper binds the C
    entry with its argument counts."""
    src = os.path.join(os.path.dirname(cuda_mla.__file__), "..", "csrc", "mla_attention.cu")
    with open(src) as f:
        text = f.read()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))

    assert const("MLA_SPLIT_KEYS") == cuda_mla.SPLIT_KEYS
    assert (const("MLA_NARROW_ROWS"), const("MLA_WIDE_ROWS")) == (cuda_mla.NARROW_ROWS,
                                                                   cuda_mla.WIDE_ROWS)
    # the merge's 2 floats a (split, row) fit each form's Q bytes
    for rows in (cuda_mla.NARROW_ROWS, cuda_mla.WIDE_ROWS):
        assert (2 * cuda_mla.MAX_SPLITS + 1) * rows * 4 <= rows * cuda_mla.D_QK * 2
    # the wide form's setmaxnreg split: a block of WIDE_THREADS starts at
    # the launch bound's share of the SM's 65,536 registers (a multiple of
    # 8), and the producer warpgroup frees at least what the consumers take
    threads, consumers = const("WIDE_THREADS"), const("WIDE_CONSUMERS")
    producer_regs, consumer_regs = const("WIDE_PRODUCER_REGS"), const("WIDE_CONSUMER_REGS")
    start = 65536 // threads // 8 * 8
    assert threads - consumers == 128 and consumers == 2 * 128
    assert producer_regs % 8 == 0 and consumer_regs % 8 == 0
    assert 24 <= producer_regs < start < consumer_regs <= 256
    assert (start - producer_regs) * 128 >= (consumer_regs - start) * consumers
    sig =re.search(r'extern "C" int dtt_latent_attention\(([^)]*)\)', text).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert params[-1] == "void* stream"
    assert sum("void*" in p for p in params[:-1]) == cuda_mla.KERNEL.n_ptrs
    assert sum(p.startswith("int ") for p in params) == cuda_mla.KERNEL.n_ints
