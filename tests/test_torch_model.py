"""The port's llama model (dynamo_tpu_torch/models/llama.py) against the JAX
model on the same weights.

Weights come from the JAX package's ``init_params`` (float32), go through
numpy and ``engine.weights.params_from_numpy``; both models run a causal
attend over the same tokens. Tolerance 1e-4 on the float32 logits: two
layers of float32 matmuls summed in different orders by XLA and PyTorch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.models import llama as jllama
from dynamo_tpu.ops import attention as jatt
from dynamo_tpu_torch.engine.weights import params_from_numpy
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.ops import attention as tatt

TOL = 1e-4

VARIANTS = {
    "tiny": {},
    "qkv_bias": {"qkv_bias": True, "tie_embeddings": False},
    "qk_norm_tied": {"qk_norm": True, "tie_embeddings": True},
}


def _configs(variant):
    kw = dict(
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        num_kv_heads=2, head_dim=16, intermediate_size=128,
    )
    kw.update(VARIANTS[variant])
    return (
        jllama.LlamaConfig(dtype=jnp.float32, **kw),
        tllama.LlamaConfig(dtype=torch.float32, **kw),
    )


def _numpy_params(jcfg, seed):
    """JAX init, then non-trivial biases / norm weights (init leaves them
    at 0 / 1, which would not exercise their code paths)."""
    tree = jax.tree.map(np.asarray, jllama.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lp in tree["layers"]:
        for name in ("bq", "bk", "bv", "q_norm", "k_norm", "attn_norm", "mlp_norm"):
            if name in lp:
                base = 1.0 if "norm" in name else 0.0
                lp[name] = (base + 0.1 * rng.standard_normal(lp[name].shape)).astype(np.float32)
    return tree


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_logits_match_jax(variant):
    jcfg, tcfg = _configs(variant)
    tree = _numpy_params(jcfg, seed=3)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, size=24).astype(np.int32)
    positions = np.arange(24, dtype=np.int32)

    jparams = jax.tree.map(jnp.asarray, tree)
    jh = jllama.forward(
        jparams, jcfg, jnp.asarray(tokens), jnp.asarray(positions),
        lambda q, k, v, i: jatt.causal_attention(q, k, v),
    )
    want = jllama.lm_logits(jparams, jcfg, jh)

    tparams = params_from_numpy(tree, tcfg, device="cpu")
    th = tllama.forward(
        tparams, tcfg, torch.from_numpy(tokens), torch.from_numpy(positions),
        lambda q, k, v, i: tatt.causal_attention(q, k, v),
    )
    got = tllama.lm_logits(tparams, tcfg, th)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 3, 16)).astype(np.float32)
    pos = np.asarray([0, 1, 7, 300, 4095], np.int32)
    jc, js = jllama.rope_cos_sin(jnp.asarray(pos), 16, 500000.0)
    want = jllama.apply_rope(jnp.asarray(x), jc[:, None, :], js[:, None, :])
    tc, ts = tllama.rope_cos_sin(torch.from_numpy(pos), 16, 500000.0)
    got = tllama.apply_rope(torch.from_numpy(x), tc[:, None, :], ts[:, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_rms_norm_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    want = jllama.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = tllama.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_presets_match_jax():
    """Each preset the port names has the reference's architecture."""
    for name, fn in (("llama3_8b", "llama3_8b"), ("llama3_70b", "llama3_70b"),
                     ("qwen3_0_6b", "qwen3_0_6b")):
        j, t = getattr(jllama.LlamaConfig, fn)(), getattr(tllama.LlamaConfig, fn)()
        for field in ("vocab_size", "hidden_size", "num_layers", "num_heads",
                      "num_kv_heads", "head_dim", "intermediate_size",
                      "rope_theta", "qk_norm", "tie_embeddings"):
            assert getattr(j, field) == getattr(t, field), (name, field)
        assert t.dtype == torch.bfloat16


def test_init_params_seeded_in_model_dtype():
    """Random init draws every tensor in the model dtype from the given
    generator: same seed, same weights; shapes as the reference's."""
    cfg = tllama.LlamaConfig(vocab_size=64, hidden_size=32, num_layers=2,
                             num_heads=4, num_kv_heads=2, head_dim=8,
                             intermediate_size=48, tie_embeddings=False)
    a = tllama.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    b = tllama.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    assert a["embed"].dtype == torch.bfloat16
    assert a["lm_head"].shape == (32, 64)
    assert a["layers"][1]["w_down"].shape == (48, 32)
    assert torch.equal(a["layers"][1]["wq"], b["layers"][1]["wq"])
    std = a["layers"][0]["w_gate"].float().std().item()
    assert abs(std - 32 ** -0.5) < 0.05


def test_params_from_numpy_refuses_unknown_parameters():
    jcfg, tcfg = _configs("tiny")
    tree = _numpy_params(jcfg, seed=0)
    tree["layers"][0]["mystery"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="mystery"):
        params_from_numpy(tree, tcfg, device="cpu")


def test_default_device_is_the_gpu():
    """Entry points run on the card unless the caller asks for the CPU:
    without a GPU the default raises instead of falling back."""
    from dynamo_tpu_torch.device import resolve_device, resolve_dtype

    assert resolve_dtype("bf16") is torch.bfloat16
    assert resolve_dtype("f32") is resolve_dtype(torch.float32) is torch.float32
    with pytest.raises(ValueError, match="dtype"):
        resolve_dtype("f16")
    assert resolve_device("cpu").type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device(None)
    else:
        assert resolve_device(None).type == "cuda"
