"""Tensor parallelism on the CPU: the port's TP group (parallel/,
runtime/multihost.py, TorchEngine(tp=2)) against the reference's ``tp``
mesh on the forced host devices tests/conftest.py sets up.

- Shards: for the llama (untied lm_head), Qwen2 (qkv biases) and Qwen3
  (qk-norm) layouts, every parameter's ``shard_params`` part, and the KV
  cache's and int8 scale rows' slices, equal the reference's
  ``NamedSharding`` shard on a tp=2 mesh exactly.
- Per-rank attention: the port's plain decode (float32 and int8),
  flash-extend and unified ops on each rank's head shard, concatenated
  over heads, equal the reference's three ``sharded_*`` Pallas wrappers on
  a tp=2 mesh in interpret mode, within 1e-5.
- Collectives: every rank of a gloo group gets the same bits back from
  ``all_reduce`` and ``all_gather`` (and the sum is the numpy sum).

The engine at tp=2: tests/test_torch_tp_engine.py (the model-dtype cache)
and tests/test_torch_tp_int8.py (the int8 cache). Ranks are processes of
tests/torch_tp_rank.py on free ports.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models import registry as jregistry
from dynamo_tpu.ops import pallas_attention as pa
from dynamo_tpu.ops import pallas_prefill as pf
from dynamo_tpu.ops import pallas_unified as pun
from dynamo_tpu.parallel.mesh import AXIS_TP, make_mesh
from dynamo_tpu_torch.engine.weights import params_from_numpy, shard_params
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified
from dynamo_tpu_torch.parallel import mesh as tmesh
from dynamo_tpu_torch.runtime.multihost import local_group_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK = os.path.join(REPO, "tests", "torch_tp_rank.py")

ATT_TOL = 1e-5
MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
LAYOUTS = {"llama": dict(tie_embeddings=False), "qwen2": dict(qkv_bias=True),
           "qwen3": dict(qk_norm=True)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _mesh():
    return make_mesh(tp=2, devices=jax.devices()[:2])


def _ref_shard(x, mesh, spec, rank):
    """The reference's rank-``rank`` shard of ``x`` under ``spec``."""
    arr = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    dev = mesh.devices.flat[rank]
    (shard,) = [s for s in arr.addressable_shards if s.device == dev]
    return np.asarray(shard.data)


def _jax_weights(layout: str, seed: int = 5):
    jcfg = jllama.LlamaConfig(dtype=jnp.float32, **MODEL, **LAYOUTS[layout])
    params = jllama.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.qkv_bias:
        # nonzero biases, so a bias sliced off its heads shows
        key = jax.random.PRNGKey(seed + 1)
        for lp in params["layers"]:
            for name in ("bq", "bk", "bv"):
                key, sub = jax.random.split(key)
                lp[name] = 0.1 * jax.random.normal(sub, lp[name].shape, jnp.float32)
    return jcfg, params, jax.tree.map(np.asarray, params)


# ------------------------------------------------------------------ shards
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_shards_equal_the_references_named_sharding(layout):
    jcfg, _, tree = _jax_weights(layout)
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL, **LAYOUTS[layout])
    specs, mesh = jregistry.param_specs(jcfg), _mesh()
    whole = params_from_numpy(tree, tcfg, device="cpu")
    checked = 0
    for rank in range(2):
        host = shard_params(tree, tcfg, rank, 2)
        dev = shard_params(whole, tcfg, rank, 2)
        pairs = [(name, tree[name], host[name], dev[name], specs["top"].get(name, specs["default"]))
                 for name in tree if name != "layers"]
        for i, lp in enumerate(tree["layers"]):
            pairs += [(f"layers.{i}.{n}", w, host["layers"][i][n], dev["layers"][i][n],
                       specs["layer"].get(n, specs["default"])) for n, w in lp.items()]
        for name, whole_w, got_host, got_dev, spec in pairs:
            want = _ref_shard(whole_w, mesh, spec, rank)
            np.testing.assert_array_equal(got_host, want, err_msg=name)
            np.testing.assert_array_equal(got_dev.numpy(), want, err_msg=name)
            assert got_dev.is_contiguous(), name
            checked += 1
    # every parameter of the layout, the layout's own ones included
    extra = {"llama": "lm_head", "qwen2": "bq", "qwen3": "q_norm"}[layout]
    assert any(extra in name for name, *_ in pairs) and checked == 2 * len(pairs)


@pytest.mark.parametrize("kind", ["model", "int8"])
def test_cache_slices_equal_the_references_named_sharding(kind):
    jcfg, _, _ = _jax_weights("llama")
    tcfg = tllama.LlamaConfig(dtype=torch.float32, **MODEL)
    rng = np.random.default_rng(0)
    mesh = _mesh()
    cache = rng.standard_normal((12, 4, jcfg.num_kv_heads, jcfg.head_dim)).astype(np.float32)
    scales = rng.standard_normal((12, jcfg.num_kv_heads)).astype(np.float32)
    for rank in range(2):
        if kind == "int8":
            want = _ref_shard(scales, mesh, jregistry.kv_scale_spec(jcfg, 2), rank)
            np.testing.assert_array_equal(tmesh.kv_scale_shard(scales, tcfg, rank, 2), want)
            np.testing.assert_array_equal(
                tmesh.kv_scale_shard(_t(scales), tcfg, rank, 2).numpy(), want)
            codes = rng.integers(-127, 128, cache.shape).astype(np.int8)
            want = _ref_shard(codes, mesh, jregistry.kv_cache_spec(jcfg, 2), rank)
            np.testing.assert_array_equal(tmesh.kv_cache_shard(_t(codes), tcfg, rank, 2).numpy(),
                                          want)
        else:
            want = _ref_shard(cache, mesh, jregistry.kv_cache_spec(jcfg, 2), rank)
            np.testing.assert_array_equal(tmesh.kv_cache_shard(cache, tcfg, rank, 2), want)
            np.testing.assert_array_equal(
                tmesh.kv_cache_shard(_t(cache), tcfg, rank, 2).numpy(), want)


def test_a_shape_that_does_not_divide_is_refused():
    cfg = tllama.LlamaConfig(dtype=torch.float32, **dict(MODEL, num_kv_heads=1))
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 6"):
        tmesh.kv_cache_shard(np.zeros((4, 4, 1, 16)), cfg, 0, 2)
    with pytest.raises(ValueError, match="ROADMAP.md Queue 1 item 6"):
        tmesh.local_config(cfg, 2)
    local = tmesh.local_config(tllama.LlamaConfig(**MODEL), 2)
    assert (local.num_heads, local.num_kv_heads, local.intermediate_size,
            local.hidden_size, local.vocab_size) == (2, 1, 64, 64, 512)


# -------------------------------------------------------- per-rank attention
def _paged(rng, lens, h=8, kvh=4, d=16, bs=8, num_blocks=32, max_blocks=6):
    B = len(lens)
    q = rng.standard_normal((B, h, d)).astype(np.float32)
    kc = rng.standard_normal((num_blocks, bs, kvh, d)).astype(np.float32)
    vc = rng.standard_normal((num_blocks, bs, kvh, d)).astype(np.float32)
    tables = np.zeros((B, max_blocks), np.int32)
    free = list(rng.permutation(np.arange(1, num_blocks)))
    for b, n in enumerate(lens):
        for j in range(-(-n // bs)):
            tables[b, j] = free.pop()
    return q, kc, vc, tables, np.asarray(lens, np.int32)


def _heads(x, rank, dim=1):
    return tmesh.shard(x, dim, rank, 2)


def _per_rank(fn):
    """The port's op on each rank's head shard, concatenated over heads."""
    return torch.cat([fn(r) for r in range(2)], dim=1).numpy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATT_TOL,
                               rtol=ATT_TOL)


@pytest.mark.parametrize("int8", [False, True], ids=["float32", "int8"])
def test_per_rank_decode_equals_the_sharded_pallas_decode(int8):
    from dynamo_tpu.ops.quant import QuantizedKV as JQ
    from dynamo_tpu.ops.quant import quantize_blocks as jquant
    from dynamo_tpu_torch.ops.quant import QuantizedKV, quantize_blocks

    rng = np.random.default_rng(1)
    q, kc, vc, tables, lens = _paged(rng, [5, 17, 40, 1])
    cfg = tllama.LlamaConfig(num_heads=8, num_kv_heads=4, head_dim=16)
    if int8:
        jk, jv = (JQ(*jquant(jnp.asarray(a))) for a in (kc, vc))
        tk, tv = (QuantizedKV(*quantize_blocks(_t(a))) for a in (kc, vc))

        def cache(c, r):
            return QuantizedKV(tmesh.kv_cache_shard(c.data, cfg, r, 2).contiguous(),
                               tmesh.kv_scale_shard(c.scale, cfg, r, 2).contiguous())
    else:
        jk, jv, tk, tv = jnp.asarray(kc), jnp.asarray(vc), _t(kc), _t(vc)

        def cache(c, r):
            return tmesh.kv_cache_shard(c, cfg, r, 2).contiguous()
    with _mesh() as mesh:
        want = pa.sharded_paged_decode_attention(
            mesh, AXIS_TP, jnp.asarray(q), jk, jv, jnp.asarray(tables), jnp.asarray(lens),
            chunk_tokens=64, interpret=True)
    got = _per_rank(lambda r: cuda_attention.paged_decode_attention(
        _heads(_t(q), r).contiguous(), cache(tk, r), cache(tv, r), _t(tables), _t(lens)))
    _close(got, want)


def test_per_rank_flash_extend_equals_the_sharded_pallas_flash_extend():
    rng = np.random.default_rng(2)
    S, T, h, kvh, d, start, total = 32, 64, 8, 4, 16, 20, 52
    q = rng.standard_normal((S, h, d)).astype(np.float32)
    k = rng.standard_normal((T, kvh, d)).astype(np.float32)
    v = rng.standard_normal((T, kvh, d)).astype(np.float32)
    with _mesh() as mesh:
        want = pf.sharded_flash_extend_attention(
            mesh, AXIS_TP, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.arange(start, start + S, dtype=jnp.int32), jnp.int32(total),
            q_tile=32, kv_tile=64, interpret=True)
    got = _per_rank(lambda r: cuda_prefill.flash_extend_attention(
        _heads(_t(q), r).contiguous(), _heads(_t(k), r).contiguous(),
        _heads(_t(v), r).contiguous(), start, total))
    _close(got[:total - start], np.asarray(want)[:total - start])


def test_per_rank_unified_equals_the_sharded_pallas_unified():
    rng = np.random.default_rng(3)
    rows = [(12, 36), (1, 17), (0, 0), (1, 9)]
    _, kc, vc, tables, lens = _paged(rng, [sl for _, sl in rows])
    starts = np.asarray([0, 15, 19, 19], np.int32)
    qlens = np.asarray([ql for ql, _ in rows], np.int32)
    q = rng.standard_normal((22, 8, 16)).astype(np.float32)
    with _mesh() as mesh:
        want = pun.sharded_ragged_paged_attention(
            mesh, AXIS_TP, *map(jnp.asarray, (q, kc, vc, tables, starts, qlens, lens)),
            q_seg=4, chunk_tokens=64, interpret=True)
    cfg = tllama.LlamaConfig(num_heads=8, num_kv_heads=4, head_dim=16)
    got = _per_rank(lambda r: cuda_unified.ragged_paged_attention(
        _heads(_t(q), r).contiguous(), tmesh.kv_cache_shard(_t(kc), cfg, r, 2).contiguous(),
        tmesh.kv_cache_shard(_t(vc), cfg, r, 2).contiguous(), *map(_t, (tables, starts, qlens,
                                                                       lens))))
    live = np.concatenate([np.arange(s, s + n) for s, n in zip(starts, qlens)])
    _close(got[live], np.asarray(want)[live])


# -------------------------------------------------------------- collectives
def start_ranks(args_of, tmp_path, tp=2):
    """Start tests/torch_tp_rank.py once per rank of a fresh local group;
    returns a function that waits (up to ``timeout`` seconds) and returns
    each rank's JSON report."""
    specs = local_group_specs(tp)
    outs = [str(tmp_path / f"rank{s.process_id}.json") for s in specs]
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, RANK, *args_of(s.text(), out)], env=env, cwd=REPO)
             for s, out in zip(specs, outs)]

    def wait(timeout: float = 120.0):
        try:
            codes = [p.wait(timeout) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        assert codes == [0] * tp, codes
        reports = []
        for out in outs:
            with open(out) as f:
                reports.append(json.load(f))
        return reports

    return wait


@pytest.mark.parametrize("tp", [2, 3])
def test_collectives_give_every_rank_the_same_bits(tmp_path, tp):
    reports = start_ranks(lambda spec, out: ["--collectives", spec, out], tmp_path, tp=tp)()
    first = reports[0]
    for r in reports[1:]:
        assert r["all_reduce"] == first["all_reduce"]
        assert r["all_gather"] == first["all_gather"]
    # the sum is the numpy sum of every rank's input (float32 and bf16 in), up
    # to the order of the float32 additions
    for kind, got in first["all_reduce"].items():
        parts = [np.asarray(r["inputs"][kind], np.float32) for r in reports]
        np.testing.assert_allclose(np.asarray(got, np.float32), np.sum(parts, axis=0),
                                   rtol=1e-2 if kind == "bf16" else 1e-5)
    np.testing.assert_array_equal(
        np.asarray(first["all_gather"]["float32"], np.float32),
        np.concatenate([np.asarray(r["inputs"]["float32"], np.float32) for r in reports], -1))
