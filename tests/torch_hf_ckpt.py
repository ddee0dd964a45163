"""Tiny HuggingFace-format checkpoints written in the test, one builder per
family the loaders map: config.json plus ``*.safetensors`` shards with HF
tensor names and ``[out, in]`` layouts, random values from
``np.random.default_rng(seed)``, stored as F32 or BF16 (through
``ml_dtypes``), split over ``shards`` files. Not a test module: the
checkpoint tests import it.
"""

import json
import os

import ml_dtypes
import numpy as np
from safetensors.numpy import save_file

VOCAB = 512


def _write(path, config, tensors, dtype="F32", shards=2):
    """config.json and the tensors, cast to ``dtype`` (float tensors only),
    over ``shards`` files in name order."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config, f)
    cast = {"F32": np.float32, "BF16": ml_dtypes.bfloat16, "F16": np.float16}[dtype]
    out = {k: v.astype(cast) if v.dtype == np.float32 else v for k, v in tensors.items()}
    names = sorted(out)
    per = -(-len(names) // shards)
    for i in range(shards):
        part = {n: out[n] for n in names[i * per:(i + 1) * per]}
        if part:
            save_file(part, os.path.join(path, f"model-{i + 1:05d}-of-{shards:05d}.safetensors"))
    return path


class _Rng:
    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def w(self, *shape, std=0.05):
        return (self.rng.standard_normal(shape) * std).astype(np.float32)

    def norm(self, n, base=1.0):
        return (base + self.rng.standard_normal(n) * 0.05).astype(np.float32)


def llama(path, model_type="llama", dtype="F32", seed=0, tie=False, layers=2,
          hidden=64, heads=4, kv_heads=2, head_dim=16, inter=128, shards=2,
          drop=(), vocab=VOCAB):
    """llama / qwen2 (q/k/v biases) / qwen3 (q/k norms) layouts."""
    r = _Rng(seed)
    cfg = {
        "model_type": model_type, "vocab_size": vocab, "hidden_size": hidden,
        "num_hidden_layers": layers, "num_attention_heads": heads,
        "num_key_value_heads": kv_heads, "head_dim": head_dim,
        "intermediate_size": inter, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 512, "tie_word_embeddings": tie,
    }
    t = {"model.embed_tokens.weight": r.w(vocab, hidden, std=0.5),
         "model.norm.weight": r.norm(hidden)}
    if not tie:
        t["lm_head.weight"] = r.w(vocab, hidden)
    q, kv = heads * head_dim, kv_heads * head_dim
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": r.norm(hidden),
            p + "post_attention_layernorm.weight": r.norm(hidden),
            p + "self_attn.q_proj.weight": r.w(q, hidden, std=0.2),
            p + "self_attn.k_proj.weight": r.w(kv, hidden, std=0.2),
            p + "self_attn.v_proj.weight": r.w(kv, hidden),
            p + "self_attn.o_proj.weight": r.w(hidden, q),
            p + "mlp.gate_proj.weight": r.w(inter, hidden),
            p + "mlp.up_proj.weight": r.w(inter, hidden),
            p + "mlp.down_proj.weight": r.w(hidden, inter),
            p + "rotary_emb.inv_freq": r.w(head_dim // 2),   # unmapped: ignored
        })
        if model_type == "qwen2":
            t.update({p + "self_attn.q_proj.bias": r.w(q), p + "self_attn.k_proj.bias": r.w(kv),
                      p + "self_attn.v_proj.bias": r.w(kv)})
        if model_type == "qwen3":
            t.update({p + "self_attn.q_norm.weight": r.norm(head_dim),
                      p + "self_attn.k_norm.weight": r.norm(head_dim)})
    for name in drop:
        t.pop(name)
    return _write(path, cfg, t, dtype, shards)


def gemma(path, version=3, dtype="F32", seed=0, multimodal=False, tie=True, layers=6,
          shards=2, drop=()):
    """Gemma 2 / Gemma 3 text, or a multimodal Gemma 3 (text_config,
    ``language_model.`` prefix, vision tensors the loader ignores)."""
    r = _Rng(seed)
    hidden, heads, kvh, hd, inter = 64, 4, 2, 16, 128
    text = {
        "model_type": "gemma2" if version == 2 else "gemma3_text",
        "vocab_size": VOCAB, "hidden_size": hidden, "num_hidden_layers": layers,
        "num_attention_heads": heads, "num_key_value_heads": kvh, "head_dim": hd,
        "intermediate_size": inter, "rms_norm_eps": 1e-6, "max_position_embeddings": 512,
        "tie_word_embeddings": tie, "query_pre_attn_scalar": 16, "sliding_window": 16,
    }
    if version == 2:
        text.update(attn_logit_softcapping=50.0, final_logit_softcapping=30.0,
                    rope_theta=10000.0)
    else:
        text.update(rope_theta=1_000_000.0, rope_local_base_freq=10_000.0,
                    rope_scaling={"rope_type": "linear", "factor": 8.0},
                    sliding_window_pattern=3,
                    layer_types=["sliding_attention" if (i + 1) % 3 else "full_attention"
                                 for i in range(layers)])
    cfg = {"model_type": "gemma3", "text_config": text} if multimodal else text
    pre = "language_model." if multimodal else ""
    t = {pre + "model.embed_tokens.weight": r.w(VOCAB, hidden, std=0.5),
         pre + "model.norm.weight": r.norm(hidden, 0.0)}
    if not tie:
        t[pre + "lm_head.weight"] = r.w(VOCAB, hidden)
    for i in range(layers):
        p = f"{pre}model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": r.norm(hidden, 0.0),
            p + "post_attention_layernorm.weight": r.norm(hidden, 0.0),
            p + "pre_feedforward_layernorm.weight": r.norm(hidden, 0.0),
            p + "post_feedforward_layernorm.weight": r.norm(hidden, 0.0),
            p + "self_attn.q_proj.weight": r.w(heads * hd, hidden, std=0.2),
            p + "self_attn.k_proj.weight": r.w(kvh * hd, hidden, std=0.2),
            p + "self_attn.v_proj.weight": r.w(kvh * hd, hidden),
            p + "self_attn.o_proj.weight": r.w(hidden, heads * hd),
            p + "mlp.gate_proj.weight": r.w(inter, hidden),
            p + "mlp.up_proj.weight": r.w(inter, hidden),
            p + "mlp.down_proj.weight": r.w(hidden, inter),
        })
        if version == 3:
            t.update({p + "self_attn.q_norm.weight": r.norm(hd, 0.0),
                      p + "self_attn.k_norm.weight": r.norm(hd, 0.0)})
    if multimodal:
        t["vision_tower.vision_model.embeddings.patch_embedding.weight"] = r.w(8, 3, 2, 2)
        t["multi_modal_projector.mm_input_projection_weight"] = r.w(8, hidden)
    for name in drop:
        t.pop(name)
    return _write(path, cfg, t, dtype, shards)


def deepseek(path, version=3, dtype="F32", seed=0, q_lora_rank=None, interleave=True,
             layers=3, shards=2, drop=()):
    """DeepSeek V2 (q_lora_rank 0, softmax routing) or V3 (a low-rank query
    if asked, sigmoid routing with groups and a balancing bias): one dense
    layer, then MoE layers with one shared expert."""
    r = _Rng(seed)
    hidden, heads, rank, nope, rope, vd, inter = 128, 4, 64, 32, 16, 32, 256
    E, moe_inter = 4, 64
    cfg = {
        "model_type": f"deepseek_v{version}", "vocab_size": VOCAB, "hidden_size": hidden,
        "num_hidden_layers": layers, "num_attention_heads": heads,
        "num_key_value_heads": heads, "q_lora_rank": q_lora_rank, "kv_lora_rank": rank,
        "qk_nope_head_dim": nope, "qk_rope_head_dim": rope, "v_head_dim": vd,
        "intermediate_size": inter, "moe_intermediate_size": moe_inter,
        "n_routed_experts": E, "num_experts_per_tok": 2, "n_shared_experts": 1,
        "first_k_dense_replace": 1, "norm_topk_prob": True, "rope_theta": 10000.0,
        "rms_norm_eps": 1e-6, "max_position_embeddings": 512,
        "tie_word_embeddings": False,
    }
    if version == 3:
        cfg.update(scoring_func="sigmoid", routed_scaling_factor=2.0, n_group=2,
                   topk_group=1, rope_interleave=interleave)
    else:
        cfg.update(scoring_func="softmax", routed_scaling_factor=1.0)
    t = {"model.embed_tokens.weight": r.w(VOCAB, hidden, std=0.5),
         "model.norm.weight": r.norm(hidden), "lm_head.weight": r.w(VOCAB, hidden)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": r.norm(hidden),
            p + "post_attention_layernorm.weight": r.norm(hidden),
            p + "self_attn.kv_a_proj_with_mqa.weight": r.w(rank + rope, hidden, std=0.2),
            p + "self_attn.kv_a_layernorm.weight": r.norm(rank),
            p + "self_attn.kv_b_proj.weight": r.w(heads * (nope + vd), rank, std=0.2),
            p + "self_attn.o_proj.weight": r.w(hidden, heads * vd),
        })
        if q_lora_rank:
            t.update({p + "self_attn.q_a_proj.weight": r.w(q_lora_rank, hidden, std=0.2),
                      p + "self_attn.q_a_layernorm.weight": r.norm(q_lora_rank),
                      p + "self_attn.q_b_proj.weight": r.w(heads * (nope + rope), q_lora_rank,
                                                           std=0.2)})
        else:
            t[p + "self_attn.q_proj.weight"] = r.w(heads * (nope + rope), hidden, std=0.2)
        if i < 1:
            t.update({p + "mlp.gate_proj.weight": r.w(inter, hidden),
                      p + "mlp.up_proj.weight": r.w(inter, hidden),
                      p + "mlp.down_proj.weight": r.w(hidden, inter)})
            continue
        t[p + "mlp.gate.weight"] = r.w(E, hidden, std=0.5)
        if version == 3:
            t[p + "mlp.gate.e_score_correction_bias"] = r.w(E, std=0.1)
        for s in ("gate_proj", "up_proj"):
            t[p + f"mlp.shared_experts.{s}.weight"] = r.w(moe_inter, hidden)
        t[p + "mlp.shared_experts.down_proj.weight"] = r.w(hidden, moe_inter)
        for e in range(E):
            q = p + f"mlp.experts.{e}."
            t.update({q + "gate_proj.weight": r.w(moe_inter, hidden),
                      q + "up_proj.weight": r.w(moe_inter, hidden),
                      q + "down_proj.weight": r.w(hidden, moe_inter)})
    for name in drop:
        t.pop(name)
    return _write(path, cfg, t, dtype, shards)


def _mxfp4(r, E, out, inn):
    """Random MXFP4 halves of an [E, out, inn] expert tensor: codes, and
    scale bytes around 127 (gentle magnitudes)."""
    blocks = r.rng.integers(0, 256, size=(E, out, inn // 32, 16), dtype=np.uint8)
    scales = r.rng.integers(118, 124, size=(E, out, inn // 32), dtype=np.uint8)
    return blocks, scales


def gptoss(path, dtype="F32", seed=0, mxfp4=False, yarn=True, layers=2, shards=2,
           drop=()):
    """gpt-oss: alternating sliding / full layers, sinks, biases, a router,
    fused experts input-major, or (``mxfp4``) as ``_blocks``/``_scales``."""
    r = _Rng(seed)
    hidden, heads, kvh, hd, inter, E = 64, 4, 2, 16, 64, 4
    cfg = {
        "model_type": "gpt_oss", "vocab_size": VOCAB, "hidden_size": hidden,
        "num_hidden_layers": layers, "num_attention_heads": heads,
        "num_key_value_heads": kvh, "head_dim": hd, "intermediate_size": inter,
        "num_local_experts": E, "num_experts_per_tok": 2, "sliding_window": 8,
        "layer_types": ["sliding_attention" if i % 2 == 0 else "full_attention"
                        for i in range(layers)],
        "rope_theta": 150000.0, "rms_norm_eps": 1e-5, "max_position_embeddings": 4096,
        "attention_bias": True, "tie_word_embeddings": False,
    }
    if yarn:
        cfg["rope_scaling"] = {"rope_type": "yarn", "factor": 32.0, "beta_fast": 32.0,
                               "beta_slow": 1.0, "truncate": False,
                               "original_max_position_embeddings": 128}
    t = {"model.embed_tokens.weight": r.w(VOCAB, hidden, std=0.5),
         "model.norm.weight": r.norm(hidden), "lm_head.weight": r.w(VOCAB, hidden)}
    for i in range(layers):
        p = f"model.layers.{i}."
        t.update({
            p + "input_layernorm.weight": r.norm(hidden),
            p + "post_attention_layernorm.weight": r.norm(hidden),
            p + "self_attn.q_proj.weight": r.w(heads * hd, hidden, std=0.2),
            p + "self_attn.k_proj.weight": r.w(kvh * hd, hidden, std=0.2),
            p + "self_attn.v_proj.weight": r.w(kvh * hd, hidden),
            p + "self_attn.o_proj.weight": r.w(hidden, heads * hd),
            p + "self_attn.q_proj.bias": r.w(heads * hd),
            p + "self_attn.k_proj.bias": r.w(kvh * hd),
            p + "self_attn.v_proj.bias": r.w(kvh * hd),
            p + "self_attn.o_proj.bias": r.w(hidden),
            p + "self_attn.sinks": r.w(heads, std=1.0),
            p + "mlp.router.weight": r.w(E, hidden, std=0.5),
            p + "mlp.router.bias": r.w(E),
            p + "mlp.experts.gate_up_proj_bias": r.w(E, 2 * inter),
            p + "mlp.experts.down_proj_bias": r.w(E, hidden),
        })
        if mxfp4:
            b, s = _mxfp4(r, E, 2 * inter, hidden)
            t[p + "mlp.experts.gate_up_proj_blocks"], t[p + "mlp.experts.gate_up_proj_scales"] = b, s
            b, s = _mxfp4(r, E, hidden, inter)
            t[p + "mlp.experts.down_proj_blocks"], t[p + "mlp.experts.down_proj_scales"] = b, s
        else:
            t[p + "mlp.experts.gate_up_proj"] = r.w(E, hidden, 2 * inter)
            t[p + "mlp.experts.down_proj"] = r.w(E, inter, hidden)
    for name in drop:
        t.pop(name)
    return _write(path, cfg, t, dtype, shards)
