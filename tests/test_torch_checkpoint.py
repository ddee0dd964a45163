"""HF checkpoints through the port's own loader (engine/weights.py on
engine/safetensors_io.py) against the reference's (dynamo_tpu.engine.
weights on the safetensors package): ``config_from_hf`` field-equal, and
``load_params`` bit-identical in dtype, shape and layout (contiguous) to
``params_from_numpy`` of the reference's tree, for F32 and BF16
checkpoints of every layout (tests/torch_hf_ckpt.py writes them) under the
config's own dtype (bf16) and float32. The reference's load errors raise
the same ValueError. ``dequant_mxfp4`` is bit-equal over every (nibble,
scale byte) pair. The warm cache (engine/warm.py) round-trips bit-equal,
keys on mtime and config, and shares no entry with the reference's. On
the card, a llama-family main model whose attention shape the decode or
flash-extend kernel lacks is refused at construction (checked here with
``device="cuda"``: the check runs before anything is allocated).
"""

import asyncio
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

import torch_hf_ckpt as ck
from dynamo_tpu.engine import warm as jwarm
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.engine import warm as twarm
from dynamo_tpu_torch.engine import weights as tweights
from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.llm.protocols.common import (
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)
from dynamo_tpu_torch.models.llama import LlamaConfig
from dynamo_tpu_torch.models.registry import PRESETS
from dynamo_tpu_torch.runtime import Context

LAYOUTS = {
    "llama": lambda p, dt: ck.llama(p, dtype=dt),
    "qwen2": lambda p, dt: ck.llama(p, "qwen2", dtype=dt),
    "qwen3": lambda p, dt: ck.llama(p, "qwen3", dtype=dt, tie=True),
    "gemma2": lambda p, dt: ck.gemma(p, 2, dtype=dt),
    "gemma3": lambda p, dt: ck.gemma(p, 3, dtype=dt),
    "gemma3-multimodal": lambda p, dt: ck.gemma(p, 3, dtype=dt, multimodal=True, tie=False),
    "deepseek_v2": lambda p, dt: ck.deepseek(p, 2, dtype=dt),
    "deepseek_v3": lambda p, dt: ck.deepseek(p, 3, dtype=dt, q_lora_rank=24),
    "deepseek_v3-rotate-half": lambda p, dt: ck.deepseek(p, 3, dtype=dt, q_lora_rank=24,
                                                         interleave=False),
    "gpt_oss": lambda p, dt: ck.gptoss(p, dtype=dt),
    "gpt_oss-mxfp4": lambda p, dt: ck.gptoss(p, dtype=dt, mxfp4=True),
}


def _same_config(tcfg, jcfg):
    assert type(tcfg).__name__ == type(jcfg).__name__
    for f in dataclasses.fields(jcfg):
        want, got = getattr(jcfg, f.name), getattr(tcfg, f.name)
        if f.name == "dtype":
            assert str(got).removeprefix("torch.") == np.dtype(want).name, f.name
        else:
            assert got == want and type(got) is type(want), (f.name, got, want)


def assert_bit_identical(got, want, where="params"):
    """Same keys, dtypes, shapes, strides (contiguous) and bytes."""
    if isinstance(want, dict):
        assert set(got) == set(want), (where, set(got) ^ set(want))
        for k in want:
            assert_bit_identical(got[k], want[k], f"{where}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_bit_identical(g, w, f"{where}/{i}")
    else:
        assert got.dtype == want.dtype and got.shape == want.shape, (where, got.dtype,
                                                                   want.dtype)
        assert got.is_contiguous() and got.stride() == want.stride(), where
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8)), where


def _reference_params(path, jcfg, tcfg):
    tree = jax.tree.map(np.asarray, jweights.load_params(path, jcfg))
    return params_from_numpy(tree, tcfg, device="cpu")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_config_from_hf_matches_the_reference(tmp_path, layout):
    path = LAYOUTS[layout](str(tmp_path / layout), "F32")
    jcfg, tcfg = jweights.config_from_hf(path), tweights.config_from_hf(path)
    _same_config(tcfg, jcfg)
    if layout == "gpt_oss":
        assert tcfg.rope_scaling_factor == 32.0 and tcfg.window_for_layer(0) == 8
    if layout.startswith("gemma3"):
        assert tcfg.qk_norm and tcfg.rope_local_theta == 10_000.0
        assert tcfg.kind_for_layer(2) == "full"
    if layout == "deepseek_v3-rotate-half":
        assert not tcfg.rope_interleave and tcfg.n_group == 2


@pytest.mark.parametrize("dtype", ["F32", "BF16"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_load_params_is_bit_identical_to_the_reference(tmp_path, layout, dtype):
    """In the config's own dtype (bf16) and in float32."""
    path = LAYOUTS[layout](str(tmp_path / layout), dtype)
    jcfg, tcfg = jweights.config_from_hf(path), tweights.config_from_hf(path)
    assert_bit_identical(tweights.load_params(path, device="cpu"),
                         _reference_params(path, jcfg, tcfg))
    jcfg32 = dataclasses.replace(jcfg, dtype=np.float32)
    tcfg32 = dataclasses.replace(tcfg, dtype=torch.float32)
    got = tweights.load_params(path, tcfg32, device="cpu")
    assert_bit_identical(got, _reference_params(path, jcfg32, tcfg32))
    f32 = {"gpt_oss": "sinks", "gpt_oss-mxfp4": "sinks", "deepseek_v3": "router_bias"}
    if layout in f32:
        key = f32[layout]
        layer = next(lp for lp in got["layers"] if key in lp)
        assert layer[key].dtype == torch.float32


def _errors(path, tcfg=None):
    with pytest.raises(ValueError) as ref:
        jweights.load_params(path)
    with pytest.raises(ValueError) as port:
        tweights.load_params(path, tcfg, device="cpu")
    return str(port.value), str(ref.value)


def test_load_errors_match_the_reference(tmp_path):
    # a missing layer
    path = ck.llama(str(tmp_path / "a"), drop=("model.layers.1.self_attn.q_proj.weight",))
    got, want = _errors(path)
    assert got == want and "missing layers [1]" in got
    # an untied Gemma without lm_head
    path = ck.gemma(str(tmp_path / "b"), 3, tie=False, drop=("lm_head.weight",))
    got, want = _errors(path)
    assert got == want and "no lm_head.weight" in got
    # a missing expert shard
    path = ck.deepseek(str(tmp_path / "c"), 2,
                       drop=("model.layers.2.mlp.experts.3.up_proj.weight",))
    got, want = _errors(path)
    assert got == want and got == "layer 2: 3/4 up_proj expert shards in checkpoint"
    # an unpaired MXFP4 half
    path = ck.gptoss(str(tmp_path / "d"), mxfp4=True,
                     drop=("model.layers.1.mlp.experts.down_proj_scales",))
    got, want = _errors(path)
    assert got == want and "missing their other half" in got


def test_dequant_mxfp4_is_bit_equal_over_every_nibble_and_scale():
    """Row s of the blocks has scale byte s and holds every nibble, as low
    and as high half: all 16 x 256 pairs (subnormals, 2**127, inf)."""
    nib = np.arange(16, dtype=np.uint8)
    row = np.concatenate([nib[0::2] | (nib[1::2] << 4), nib[1::2] | (nib[0::2] << 4)])
    blocks = np.broadcast_to(row, (256, 16)).reshape(1, 256, 1, 16).copy()
    scales = np.arange(256, dtype=np.uint8).reshape(1, 256, 1)
    want = np.ascontiguousarray(jweights.dequant_mxfp4(blocks, scales))
    got = tweights.dequant_mxfp4(torch.from_numpy(blocks), torch.from_numpy(scales))
    assert got.dtype == torch.float32 and got.is_contiguous() and got.shape == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    table = tweights.mxfp4_table()                         # [scale, nibble]
    assert table[255, 1] == np.float32(2.0 ** 127)            # 0.5 * 2**128: finite
    assert np.isposinf(table[255, 7]) and np.isneginf(table[255, 15])
    assert table[0, 1] == np.float32(2.0 ** -128)             # a subnormal
    assert table[255, 0] == 0 and np.signbit(table[255, 8])   # signed zeros, no NaN
    assert not np.isnan(table).any()


def test_warm_cache_round_trip_is_bit_equal_and_keys_on_mtime_and_config(tmp_path):
    path = ck.gptoss(str(tmp_path / "ckpt"), dtype="BF16", mxfp4=True)
    cfg = tweights.config_from_hf(path)
    cache = twarm.WarmWeightCache(str(tmp_path / "warm"))
    cold = twarm.load_params_warm(path, cfg, cache, device="cpu")
    assert cache.has(path, cfg)
    warm = cache.load(path, cfg, "cpu")
    assert_bit_identical(warm, cold)
    assert_bit_identical(twarm.load_params_warm(path, cfg, cache, device="cpu"), cold)
    assert_bit_identical(cold, tweights.load_params(path, device="cpu"))
    # another config, another entry
    assert not cache.has(path, dataclasses.replace(cfg, dtype=torch.float32))
    # the checkpoint directory changes: another entry
    key = twarm.fingerprint(path, cfg)
    st = os.stat(path)
    os.utime(path, (st.st_atime, st.st_mtime + 10))
    assert twarm.fingerprint(path, cfg) != key and not cache.has(path, cfg)


def test_warm_cache_shares_no_entry_with_the_reference(tmp_path, monkeypatch):
    path = ck.llama(str(tmp_path / "ckpt"), dtype="BF16")
    root = str(tmp_path / "warm")
    monkeypatch.setenv("DTPU_WARM_CACHE", root)
    jcfg, tcfg = jweights.config_from_hf(path), tweights.config_from_hf(path)
    jwarm.WarmWeightCache(root).save(path, jcfg, jweights.load_params(path, jcfg))
    ref_entries = set(os.listdir(root))
    cache = twarm.WarmWeightCache()
    assert cache.root == root
    assert cache.load(path, tcfg, "cpu") is None
    twarm.load_params_warm(path, tcfg, device="cpu")
    ours = set(os.listdir(root)) - ref_entries
    assert len(ours) == 1 and ref_entries
    # a reference entry is not read as the port's, even when asked directly
    with pytest.raises(ValueError, match="not an entry"):
        twarm.load_manifest_dir(os.path.join(root, ref_entries.pop()), "cpu")
    assert twarm.default_root() == root
    monkeypatch.delenv("DTPU_WARM_CACHE")
    assert twarm.default_root().endswith(os.path.join(".cache", "dynamo_tpu_torch", "warm"))


# published configs (huggingface.co/<name>/config.json) the loader reads,
# at attention shapes the card's decode / flash-extend kernels took only
# from their group sizes 3-7 and head_dim 64 on
CARD_REFUSED = {
    "Qwen2.5-0.5B": dict(model_type="qwen2", hidden_size=896, num_attention_heads=14,
                         num_key_value_heads=2, intermediate_size=4864),
    "Qwen2.5-1.5B": dict(model_type="qwen2", hidden_size=1536, num_attention_heads=12,
                         num_key_value_heads=2, intermediate_size=8960),
    "Llama-3.2-1B": dict(model_type="llama", hidden_size=2048, num_attention_heads=32,
                         num_key_value_heads=8, head_dim=64, intermediate_size=8192),
}
CARD_SERVED = {
    "Qwen3-0.6B": dict(model_type="qwen3", hidden_size=1024, num_attention_heads=16,
                       num_key_value_heads=8, head_dim=128, intermediate_size=3072),
}


def _hf_config(tmp_path, name, fields):
    d = tmp_path / name
    d.mkdir()
    (d / "config.json").write_text(json.dumps(
        dict(vocab_size=1024, num_hidden_layers=1, **fields)))
    return tweights.config_from_hf(str(d))


@pytest.mark.parametrize("name", list(CARD_REFUSED))
def test_card_refuses_a_main_model_the_kernels_lack_at_construction(tmp_path, name):
    """The published shape, read through config_from_hf, is taken on the
    card; the same shape at a head_dim the kernels lack (96) is refused
    before anything is allocated (no card here), naming ROADMAP; the CPU
    serves both."""
    cfg = _hf_config(tmp_path, name, CARD_REFUSED[name])
    for device in ("cuda", None):
        engine_mod._check_features(TorchEngineConfig(model=cfg, device=device))
        with pytest.raises(ValueError, match=r"ROADMAP.md \(Queue 1\)"):
            TorchEngine(TorchEngineConfig(model=dataclasses.replace(cfg, head_dim=96),
                                          device=device))
    small = dataclasses.replace(cfg, hidden_size=64, intermediate_size=64, vocab_size=64,
                                head_dim=96, dtype=torch.float32)
    engine = TorchEngine(TorchEngineConfig(model=small, device="cpu", num_blocks=16,
                                           max_context=64, prefill_buckets=(16, 64),
                                           decode_steps=1, decode_pipeline=1))

    async def serve():
        req = PreprocessedRequest(request_id="r", model="m", token_ids=[1, 2, 3],
                                  stop=StopConditions(max_tokens=3),
                                  sampling=SamplingOptions(temperature=0.0))
        return [t async for o in engine.generate(req, Context()) for t in o.token_ids]

    try:
        assert len(asyncio.run(serve())) == 3
    finally:
        engine.stop()


def test_card_takes_qwen3_and_refuses_the_tiny_presets():
    for name, fields in CARD_SERVED.items():
        cfg = LlamaConfig(
            vocab_size=1024, num_layers=1, num_heads=fields["num_attention_heads"],
            num_kv_heads=fields["num_key_value_heads"], head_dim=fields["head_dim"],
            hidden_size=fields["hidden_size"], intermediate_size=fields["intermediate_size"])
        engine_mod._check_features(TorchEngineConfig(model=cfg, device="cuda"))
    # tiny-moe's head_dim 16 has no kernel form; tiny's (d 64, G 2) has
    # one since the kernels took head_dim 64
    with pytest.raises(ValueError, match=r"head_dim 16.*ROADMAP.md \(Queue 1\)"):
        engine_mod._check_features(TorchEngineConfig(model=PRESETS["tiny-moe"](),
                                                     device="cuda"))
    engine_mod._check_features(TorchEngineConfig(model=PRESETS["tiny"](), device="cuda"))
    # the families served by the unified and latent kernels are not refused
    for preset in ("tiny-gemma3", "tiny-gptoss", "tiny-mla"):
        engine_mod._check_features(TorchEngineConfig(model=PRESETS[preset](), device="cuda"))
