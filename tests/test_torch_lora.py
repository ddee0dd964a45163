"""Multi-LoRA in the port (dynamo_tpu_torch/lora, the engine's
``lora_max_adapters``) against the reference's (dynamo_tpu/lora,
TpuEngine), on the CPU.

- the adapter table: load, unload, rank padding and slot exhaustion as
  the reference's, every table keeping its ``data_ptr`` across loads (the
  decode horizon's CUDA graphs hold addresses);
- ``make_lora_fn``'s deltas against the reference's within 1e-5 in its
  three input forms: one adapter over ``[S, H]``, one per slot over
  ``[B, S, H]``, and the mixed step's packed ``[T, H]`` buffer (a chunk
  plus decode rows of two adapters), which builds no ``[T, in, r]`` or
  ``[T, r, out]`` tensor;
- the npz, PEFT safetensors and PEFT ``.bin`` round trips through the
  cache.

The engine's streams: tests/test_torch_lora_engine.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dynamo_tpu import lora as jlora
from dynamo_tpu_torch import lora as tlora
from dynamo_tpu_torch.models import llama as tllama
from torch_feature_engines import Weights

MODEL = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=96)
TARGETS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
ENGINE = dict(num_blocks=128, block_size=16, max_batch_size=4, max_context=256,
              prefill_buckets=(16, 32, 64), lora_max_adapters=2, lora_rank=4,
              lora_targets=TARGETS)
TOL = 1e-5


def _adapter_weights(cfg, rank=4, seed=0, scale=1.0, targets=TARGETS):
    """The reference test's adapter (its seeds and scale), for any targets."""
    rng = np.random.default_rng(seed)
    sizes = {"wq": (cfg.hidden_size, cfg.q_size), "wk": (cfg.hidden_size, cfg.kv_size),
             "wv": (cfg.hidden_size, cfg.kv_size), "wo": (cfg.q_size, cfg.hidden_size),
             "w_gate": (cfg.hidden_size, cfg.intermediate_size),
             "w_up": (cfg.hidden_size, cfg.intermediate_size),
             "w_down": (cfg.intermediate_size, cfg.hidden_size)}
    w = {}
    for t in targets:
        inp, out = sizes[t]
        w[f"{t}.A"] = rng.standard_normal((cfg.num_layers, inp, rank)).astype(np.float32) * scale
        w[f"{t}.B"] = rng.standard_normal((cfg.num_layers, rank, out)).astype(np.float32) * scale
    return w


TCFG = tllama.LlamaConfig(dtype=torch.float32, **MODEL)


# ------------------------------------------------------------------ the table
def test_table_load_unload_pad_and_exhaust_keep_addresses():
    table = tlora.LoraAdapterTable(TCFG, max_adapters=2, rank=8, targets=TARGETS,
                                   dtype=torch.float32)
    ptrs = {k: v.data_ptr() for k, v in table.tables().items()}
    assert table.slot_of(None) == 0 and table.slot_of("missing") == 0
    w = _adapter_weights(TCFG, rank=4, seed=1)
    assert table.load("a", w, alpha=8.0) == 1                     # rank 4 padded to 8
    assert table.list_adapters() == ["a"] and table.slot_of("a") == 1
    np.testing.assert_array_equal(table.A["wq"][1, :, :, :4].numpy(), w["wq.A"])
    assert not table.A["wq"][1, :, :, 4:].any() and not table.B["wq"][1, :, 4:].any()
    assert table.scales[1].item() == 2.0                          # alpha / the adapter's rank
    assert table.load("b", _adapter_weights(TCFG, rank=8, seed=2)) == 2
    with pytest.raises(RuntimeError, match="no free adapter slots"):
        table.load("c", w)
    with pytest.raises(ValueError, match="exceeds table rank"):
        table.load("b", _adapter_weights(TCFG, rank=9))
    key_a = table.cache_key("a")
    assert table.unload("a") and not table.unload("a")
    assert not table.A["wq"][1].any() and table.scales[1].item() == 0.0
    assert table.cache_key("a") is None and table.cache_key(None) is None
    assert table.load("a", w, alpha=8.0) == 1 and table.cache_key("a") == key_a
    table.load("a", _adapter_weights(TCFG, rank=4, seed=3), alpha=8.0)   # same name, new weights
    assert table.cache_key("a") != key_a
    assert {k: v.data_ptr() for k, v in table.tables().items()} == ptrs
    with pytest.raises(ValueError, match="unknown LoRA target"):
        tlora.LoraAdapterTable(TCFG, targets=("wq", "lm_head"))


def test_rank_padding_and_exhaustion_match_the_reference():
    jcfg = Weights(MODEL).jcfg
    for pkg, cfg, dt in ((jlora, jcfg, jnp.float32), (tlora, TCFG, torch.float32)):
        table = pkg.LoraAdapterTable(cfg, max_adapters=1, rank=8, dtype=dt)
        table.load("small-rank", _adapter_weights(TCFG, rank=4, targets=TARGETS[:4]))
        with pytest.raises(RuntimeError):
            table.load("overflow", _adapter_weights(TCFG, rank=4, targets=TARGETS[:4]))
        with pytest.raises(ValueError):
            pkg.LoraAdapterTable(cfg, max_adapters=1, rank=2, dtype=dt).load(
                "too-big", _adapter_weights(TCFG, rank=4, targets=TARGETS[:4]))


# ------------------------------------------------------------ make_lora_fn
@pytest.fixture(scope="module")
def tables():
    jcfg = Weights(MODEL).jcfg
    jt = jlora.LoraAdapterTable(jcfg, max_adapters=2, rank=4, targets=TARGETS,
                                dtype=jnp.float32)
    tt = tlora.LoraAdapterTable(TCFG, max_adapters=2, rank=4, targets=TARGETS,
                                dtype=torch.float32)
    for t in (jt, tt):
        t.load("a", _adapter_weights(TCFG, seed=5, scale=2.0), alpha=8.0)
        t.load("b", _adapter_weights(TCFG, seed=9, scale=2.0))
    for k, v in jt.tables().items():
        np.testing.assert_array_equal(tt.tables()[k].numpy(), np.asarray(v))
    return jt.tables(), tt.tables()


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for o in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(o, torch.Tensor):
                self.shapes.add(tuple(o.shape))
        return out


def _ins(t):
    return {"wo": TCFG.q_size, "w_down": TCFG.intermediate_size}.get(t, TCFG.hidden_size)


@pytest.mark.parametrize("form", ["prefill", "decode", "packed"])
def test_make_lora_fn_equals_the_reference(tables, form):
    jt, tt = tables
    rng = np.random.default_rng(3)
    head, rows = 10, np.array([0, 1, 2, 1])
    shapes = _Shapes()
    for t in TARGETS:
        if form == "prefill":
            x = rng.standard_normal((6, _ins(t))).astype(np.float32) * 0.01
            jids, tids = jnp.int32(1), 1
        elif form == "decode":
            x = rng.standard_normal((3, 2, _ins(t))).astype(np.float32) * 0.01
            jids, tids = jnp.asarray([0, 2, 1], jnp.int32), torch.tensor([0, 2, 1])
        else:
            x = rng.standard_normal((head + len(rows), _ins(t))).astype(np.float32) * 0.01
            jids = jnp.asarray(np.concatenate([np.full(head, 2), rows]), jnp.int32)
            tids = tlora.PackedAdapterIds(head, 2, torch.from_numpy(rows))
        for layer in range(TCFG.num_layers):
            want = np.asarray(jlora.make_lora_fn(jt, jids)(t, layer, jnp.asarray(x)))
            with shapes:
                got = tlora.make_lora_fn(tt, tids)(t, layer, torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
            assert np.abs(want).max() > 0.1
        if form == "packed":
            T = head + len(rows)
            assert not {s for s in shapes.shapes if len(s) == 3 and s[0] == T}, shapes.shapes
    assert tlora.make_lora_fn(tt, 1)("lm_head", 0, torch.zeros(2, 64)) is None


# ------------------------------------------------------------ cache + PEFT
def test_npz_cache_round_trip(tmp_path):
    w = _adapter_weights(TCFG, seed=3)
    path = tmp_path / "adapter.npz"
    np.savez(path, alpha=np.float32(16.0), **w)
    weights, alpha = tlora.load_adapter(str(path))
    assert alpha == 16.0 and set(weights) == set(w)
    np.testing.assert_array_equal(weights["w_down.B"], w["w_down.B"])
    cache = tlora.LoRACache(root=str(tmp_path / "cache"))
    assert cache.uri_to_key("file:///a/b/x") == jlora.LoRACache.uri_to_key("file:///a/b/x")
    assert cache.uri_to_key("file:///a/b/x") != cache.uri_to_key("file:///o/x")
    out = tlora.LocalLoRASource().fetch(f"file://{path}", cache)
    assert cache.is_cached(f"file://{path}") and out == cache.path_for(f"file://{path}")
    with pytest.raises(FileNotFoundError):
        tlora.LocalLoRASource().fetch(str(tmp_path / "missing.npz"), cache)


def _peft_dir(root, fmt):
    """A HF PEFT adapter directory: lora_A [r, in] / lora_B [out, r] per
    projection and layer, with adapter_config.json."""
    import json

    rng = np.random.default_rng(4)
    names = {"wq": ("self_attn", "q_proj"), "wv": ("self_attn", "v_proj"),
             "w_up": ("mlp", "up_proj"), "w_down": ("mlp", "down_proj")}
    sizes = {"wq": (64, 64), "wv": (64, 32), "w_up": (64, 96), "w_down": (96, 64)}
    tensors = {}
    for t, (block, proj) in names.items():
        inp, out = sizes[t]
        for layer in range(2):
            pre = f"base_model.model.model.layers.{layer}.{block}.{proj}"
            tensors[f"{pre}.lora_A.weight"] = rng.standard_normal((4, inp)).astype(np.float32)
            tensors[f"{pre}.lora_B.weight"] = rng.standard_normal((out, 4)).astype(np.float32)
    d = os.path.join(root, fmt)
    os.makedirs(d)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": 4, "lora_alpha": 8}, f)
    if fmt == "safetensors":
        from safetensors.numpy import save_file

        save_file(tensors, os.path.join(d, "adapter_model.safetensors"))
    else:
        torch.save({k: torch.from_numpy(v) for k, v in tensors.items()},
                   os.path.join(d, "adapter_model.bin"))
    return d


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_peft_dir_converts_as_the_reference(tmp_path, fmt):
    d = _peft_dir(str(tmp_path), fmt)
    got, want = str(tmp_path / "port.npz"), str(tmp_path / "ref.npz")
    tlora.from_peft_dir(d, got)
    jlora.from_peft_dir(d, want)
    with np.load(got) as g, np.load(want) as r:
        assert sorted(g.files) == sorted(r.files)
        for k in r.files:
            np.testing.assert_array_equal(g[k], r[k])
    # through the source and cache, into an engine's table
    cache = tlora.LoRACache(root=str(tmp_path / "cache"))
    weights, alpha = tlora.load_adapter(tlora.LocalLoRASource().fetch(d, cache))
    assert alpha == 8.0 and weights["wq.A"].shape == (2, 64, 4)
    table = tlora.LoraAdapterTable(TCFG, max_adapters=1, rank=4, targets=TARGETS,
                                   dtype=torch.float32)
    table.load("peft", weights, alpha)
    assert table.scales[1].item() == 2.0 and not table.A["wk"][1].any()
