"""Parameters from HF checkpoints and from host arrays.

``config_from_hf`` and ``load_params`` are the counterparts of the
reference's engine/weights.py: a HuggingFace-format directory (config.json
and ``*.safetensors`` shards, read by engine/safetensors_io.py) becomes the
family's config and the port's parameter dictionary, with the reference's
tensor names, transposes, dtypes and errors. Each tensor is copied to the
target device in its stored dtype, cast and transposed there one at a
time, and every result is contiguous ``[in, out]``: bit-identical, and
laid out alike, to ``params_from_numpy`` of the reference's loader.
Released gpt-oss checkpoints store their experts in MXFP4; they are
dequantized on the target device (``dequant_mxfp4``).

Limits of the reference, mirrored: no ``qwen3_moe`` branch (such a
checkpoint reads as a dense llama config), no llama ``rope_scaling``, no
Gemma 3 vision tower, and ``torch_dtype`` is not read (the model dtype is
the config default).

``params_from_numpy`` turns the reference package's parameter pytree, as
numpy arrays (``jax.tree.map(np.asarray, params)`` on the caller's side),
into the port's parameter dictionary: the layouts are identical (weights
``[in, out]``), so each array only changes framework, device and dtype.
``vision_params_from_numpy`` does the same for the vision tower's tree
(``TpuEngine.vision_params``).

Tensor parallelism (parallel/mesh.py): ``shard_params`` takes rank ``r``'s
part of a whole parameter tree (the reference's numpy pytree, or the
port's tensors after ``load_params``), laid out as the reference's
``NamedSharding`` over its ``tp`` axis lays them out; a checkpoint is
loaded whole and then sliced. ``init_sharded_params`` draws random
weights one layer at a time and keeps rank ``r``'s part of each, so that
every rank of a group holds a shard of the same model as ``init_params``
with the same generator seed.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..models import llama, registry
from ..models.gemma import GemmaConfig
from ..models.gptoss import GptOssConfig
from ..models.llama import LlamaConfig, Params
from ..models.mla import MlaConfig
from ..models.vision import VisionConfig
from .safetensors_io import read_safetensors

log = logging.getLogger("dynamo_tpu_torch.engine.weights")

_TOP = ("embed", "final_norm", "lm_head")


def _tensor(arr: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.kind == "V" or a.dtype.name == "bfloat16":
        # ml_dtypes bfloat16 has no torch.from_numpy mapping; the widening
        # to float32 is exact
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a, copy=True)).to(device=device, dtype=dtype)


def params_from_numpy(
    tree: Dict[str, Any], cfg: LlamaConfig, device: DeviceLike = None
) -> Params:
    """Reference pytree of numpy arrays -> port params on ``device``, each
    in the reference's dtype: ``cfg.dtype``, except the family's float32
    parameters (gpt-oss's sinks, MLA's router bias). Each family has its
    own layer keys (gemma: the sandwich norms; gpt-oss: biases, sinks,
    router and experts; MoE: the router and expert stacks; MLA: the latent
    projections, and dense or MoE FFN keys by layer). Unknown keys raise:
    a parameter this port does not use must not be dropped silently."""
    device = resolve_device(device)
    unknown = set(tree) - set(_TOP) - {"layers"}
    if unknown:
        raise ValueError(f"unknown top-level parameters {sorted(unknown)}")
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(
            f"{len(tree['layers'])} layers in the tree, config has {cfg.num_layers}"
        )
    out: Params = {
        name: _tensor(tree[name], cfg.dtype, device) for name in _TOP if name in tree
    }
    layer_keys = set(registry.layer_keys(cfg))
    f32 = set(registry.float32_keys(cfg))
    layers = []
    for i, lp in enumerate(tree["layers"]):
        bad = set(lp) - layer_keys
        if bad:
            raise ValueError(f"layer {i}: unknown parameters {sorted(bad)}")
        layers.append({name: _tensor(w, torch.float32 if name in f32 else cfg.dtype, device)
                       for name, w in lp.items()})
    out["layers"] = layers
    return out


def shard_params(params: Dict[str, Any], cfg: LlamaConfig, rank: int, tp: int) -> Dict[str, Any]:
    """Rank ``rank``'s part of a whole dense-llama parameter tree of numpy
    arrays or tensors (each a contiguous copy; the rest replicated), for
    the local config ``parallel.mesh.local_config(cfg, tp)``."""
    from ..parallel import mesh as meshlib

    if registry.family(cfg) is not llama:
        raise ValueError(f"tensor parallelism covers the dense llama family only "
                         f"({meshlib.QUEUE})")
    meshlib.check_tp(cfg, tp)

    def part(x, dim):
        y = meshlib.shard(x, dim, rank, tp)
        return y.contiguous() if isinstance(y, torch.Tensor) else np.ascontiguousarray(y)

    out: Dict[str, Any] = {name: part(w, meshlib.param_dim(name, layer=False))
                           for name, w in params.items() if name != "layers"}
    out["layers"] = [{name: part(w, meshlib.param_dim(name, layer=True))
                      for name, w in lp.items()} for lp in params["layers"]]
    return out


def init_sharded_params(cfg: LlamaConfig, generator: torch.Generator, device: DeviceLike,
                        rank: int, tp: int) -> Params:
    """Rank ``rank``'s shard of ``llama.init_params(cfg, generator,
    device)``: the same draws in the same order, each layer drawn whole on
    ``device`` and cut to its part before the next, so the device holds
    one whole layer at most beside the shards."""
    device = resolve_device(device)
    whole = {"embed": llama._normal((cfg.vocab_size, cfg.hidden_size), 0.02, generator,
                                    device, cfg.dtype),
             "final_norm": torch.ones(cfg.hidden_size, device=device, dtype=cfg.dtype),
             "layers": []}
    if not cfg.tie_embeddings:
        whole["lm_head"] = llama._normal((cfg.hidden_size, cfg.vocab_size), 0.02, generator,
                                         device, cfg.dtype)
    params = shard_params(whole, cfg, rank, tp)
    del whole
    for _ in range(cfg.num_layers):
        layer = llama.init_layer_params(cfg, generator, device)
        params["layers"].append(
            shard_params({"layers": [layer]}, cfg, rank, tp)["layers"][0])
        del layer
    return params


_VISION_TOP = ("patch_embed", "pos_embed", "final_norm", "proj_up", "proj_down")
_VISION_LAYER = ("attn_norm", "mlp_norm", "wqkv", "wo", "w_up", "w_down")


def vision_params_from_numpy(
    tree: Dict[str, Any], cfg: VisionConfig, device: DeviceLike = None
) -> Params:
    """The reference's vision-tower pytree of numpy arrays -> the port's
    tower parameters on ``device`` in ``cfg.dtype`` (models/vision.py:
    the same layout). Missing or unknown keys raise."""
    device = resolve_device(device)
    if set(tree) != set(_VISION_TOP) | {"layers"}:
        raise ValueError(f"vision parameters {sorted(tree)}: expected "
                         f"{sorted(_VISION_TOP + ('layers',))}")
    if len(tree["layers"]) != cfg.num_layers:
        raise ValueError(
            f"{len(tree['layers'])} tower layers in the tree, config has {cfg.num_layers}")
    out: Params = {name: _tensor(tree[name], cfg.dtype, device) for name in _VISION_TOP}
    layers = []
    for i, lp in enumerate(tree["layers"]):
        if set(lp) != set(_VISION_LAYER):
            raise ValueError(f"tower layer {i}: parameters {sorted(lp)}, expected "
                             f"{sorted(_VISION_LAYER)}")
        layers.append({name: _tensor(w, cfg.dtype, device) for name, w in lp.items()})
    out["layers"] = layers
    return out


# --------------------------------------------------------------------------
# HF checkpoints


def config_from_hf(path: str) -> LlamaConfig:
    """``path``/config.json -> the family's config, as the reference reads
    it (llama, qwen2, qwen3 and any other model_type: LlamaConfig)."""
    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    if hf.get("model_type", "") in ("deepseek_v2", "deepseek_v3"):
        return _mla_config_from_hf(hf)
    if hf.get("model_type", "") == "gpt_oss":
        return _gptoss_config_from_hf(hf)
    if hf.get("model_type", "") in ("gemma2", "gemma3", "gemma3_text"):
        return _gemma_config_from_hf(hf)
    head_dim = hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"]
    return LlamaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=head_dim,
        intermediate_size=hf["intermediate_size"],
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_position=hf.get("max_position_embeddings", 8192),
        qkv_bias=hf.get("attention_bias", False) or hf.get("model_type", "") == "qwen2",
        qk_norm=hf.get("model_type", "") == "qwen3",
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


def _mla_config_from_hf(hf: dict) -> MlaConfig:
    """DeepSeek V2/V3 config.json -> MlaConfig."""
    return MlaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        q_lora_rank=hf.get("q_lora_rank") or 0,
        kv_lora_rank=hf["kv_lora_rank"],
        qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"],
        intermediate_size=hf["intermediate_size"],
        num_experts=hf.get("n_routed_experts") or 0,
        num_experts_per_tok=hf.get("num_experts_per_tok") or 2,
        moe_intermediate_size=hf.get("moe_intermediate_size") or 0,
        norm_topk_prob=hf.get("norm_topk_prob", True),
        moe_scoring=hf.get("scoring_func", "sigmoid"),
        routed_scaling_factor=hf.get("routed_scaling_factor", 1.0),
        num_shared_experts=hf.get("n_shared_experts") or 0,
        first_dense_layers=hf.get("first_k_dense_replace", 0),
        n_group=hf.get("n_group") or 1,
        topk_group=hf.get("topk_group") or 1,
        rope_interleave=hf.get("rope_interleave", True),
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_position=hf.get("max_position_embeddings", 8192),
        tie_embeddings=hf.get("tie_word_embeddings", False),
    )


def _gemma_config_from_hf(hf: dict) -> GemmaConfig:
    """Gemma 2 / Gemma 3 config.json -> GemmaConfig. Multimodal gemma3
    nests the language model under text_config."""
    mt = hf.get("model_type", "")
    if mt == "gemma3" and "text_config" in hf:
        hf = hf["text_config"]
        mt = hf.get("model_type", "gemma3_text")
    is3 = mt in ("gemma3", "gemma3_text")
    layer_types = tuple("sliding" if t == "sliding_attention" else "full"
                        for t in hf.get("layer_types") or ())
    rope_scaling = hf.get("rope_scaling") or {}
    return GemmaConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        rope_theta=hf.get("rope_theta", 10000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        max_position=hf.get("max_position_embeddings", 8192),
        tie_embeddings=hf.get("tie_word_embeddings", True),
        qk_norm=is3,
        query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar", 256)),
        sliding_window=hf.get("sliding_window") or 4096,
        layer_types=layer_types,
        sliding_pattern=hf.get("sliding_window_pattern", 6 if is3 else 2),
        attn_logit_softcap=hf.get("attn_logit_softcapping"),
        final_logit_softcap=hf.get("final_logit_softcapping"),
        rope_local_theta=hf.get("rope_local_base_freq") if is3 else None,
        rope_scaling_factor=float(rope_scaling.get("factor", 1.0)),
    )


def _gptoss_config_from_hf(hf: dict) -> GptOssConfig:
    """gpt-oss config.json -> GptOssConfig (YaRN from rope_scaling)."""
    rs = hf.get("rope_scaling") or {}
    yarn = rs.get("rope_type") == "yarn"
    return GptOssConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_key_value_heads"],
        head_dim=hf.get("head_dim") or hf["hidden_size"] // hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        num_experts=hf["num_local_experts"],
        num_experts_per_tok=hf["num_experts_per_tok"],
        sliding_window=hf.get("sliding_window") or 128,
        layer_types=tuple(hf.get("layer_types") or ()),
        rope_theta=hf.get("rope_theta", 150000.0),
        rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
        max_position=hf.get("max_position_embeddings", 131072),
        qkv_bias=hf.get("attention_bias", True),
        tie_embeddings=hf.get("tie_word_embeddings", False),
        rope_scaling_factor=rs.get("factor", 0.0) if yarn else 0.0,
        rope_beta_fast=rs.get("beta_fast", 32.0),
        rope_beta_slow=rs.get("beta_slow", 1.0),
        rope_truncate=rs.get("truncate", True),
        rope_original_max_position=rs.get(
            "original_max_position_embeddings", hf.get("max_position_embeddings", 4096)),
    )


def _put(w: torch.Tensor, dtype: torch.dtype, transpose: bool = False) -> torch.Tensor:
    """A loaded tensor in ``dtype`` on its device, contiguous, transposed
    from HF's ``[out, in]`` to ``[in, out]`` when asked."""
    w = w.to(dtype)
    return w.t().contiguous() if transpose else w.contiguous()


def _split_layer_name(name: str):
    """``model.layers.{i}.{rest}`` -> (i, rest), else None."""
    if not name.startswith("model.layers."):
        return None
    parts = name.split(".")
    return int(parts[2]), ".".join(parts[3:])


def load_params(path: str, cfg: Optional[LlamaConfig] = None,
                device: DeviceLike = None) -> Params:
    """HF checkpoint directory -> the port's parameters on ``device`` (cfg
    default: ``config_from_hf(path)``). Llama / Qwen2 / Qwen3 names here;
    Gemma, DeepSeek (MLA) and gpt-oss checkpoints by their configs."""
    device = resolve_device(device)
    cfg = cfg or config_from_hf(path)
    if isinstance(cfg, MlaConfig):
        return _load_params_mla(path, cfg, device)
    if isinstance(cfg, GptOssConfig):
        return _load_params_gptoss(path, cfg, device)
    if isinstance(cfg, GemmaConfig):
        return _load_params_gemma(path, cfg, device)
    layers: list = [dict() for _ in range(cfg.num_layers)]
    params: Params = {"layers": layers}
    dt = cfg.dtype
    mapping = {
        "input_layernorm.weight": ("attn_norm", False),
        "post_attention_layernorm.weight": ("mlp_norm", False),
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "self_attn.q_proj.bias": ("bq", False),
        "self_attn.k_proj.bias": ("bk", False),
        "self_attn.v_proj.bias": ("bv", False),
        "self_attn.q_norm.weight": ("q_norm", False),
        "self_attn.k_norm.weight": ("k_norm", False),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
    }
    for name, w in read_safetensors(path, device):
        layer = _split_layer_name(name)
        if name == "model.embed_tokens.weight":
            params["embed"] = _put(w, dt)
        elif name == "model.norm.weight":
            params["final_norm"] = _put(w, dt)
        elif name == "lm_head.weight":
            params["lm_head"] = _put(w, dt, True)
        elif layer is not None and layer[1] in mapping:
            ours, transpose = mapping[layer[1]]
            layers[layer[0]][ours] = _put(w, dt, transpose)
        else:
            log.debug("ignoring unmapped tensor %s", name)
        del w
    missing = [i for i, lp in enumerate(layers) if "wq" not in lp]
    if missing:
        raise ValueError(f"checkpoint at {path} missing layers {missing[:4]}...")
    log.info("loaded %d layers from %s", cfg.num_layers, path)
    return params


def _deinterleave_rope_rows(w: torch.Tensor, nope: int, rope: int, heads: int) -> torch.Tensor:
    """DeepSeek checkpoints store rope projections in interleaved pair
    layout; the model's apply_rope is rotate-half. Permute each head's rope
    OUTPUT rows [0, 1, 2, ...] -> [evens..., odds...] so the rotate-half
    pairing reproduces the interleaved semantics exactly. ``w`` is HF
    ``[out, in]`` with out = heads * (nope + rope)."""
    out, inner = w.shape
    w = w.reshape(heads, nope + rope, inner)
    perm = torch.cat([torch.arange(0, rope, 2), torch.arange(1, rope, 2)]).to(w.device)
    w = torch.cat([w[:, :nope, :], w[:, nope:, :][:, perm, :]], dim=1)
    return w.reshape(out, inner)


def _load_params_gemma(path: str, cfg: GemmaConfig, device: torch.device) -> Params:
    """HF Gemma 2/3 tensors -> the gemma parameters (the sandwich norms get
    their own names; multimodal gemma3 checkpoints prefix the text stack
    with ``language_model.``, stripped here; the vision tower is not
    loaded)."""
    layers: list = [dict() for _ in range(cfg.num_layers)]
    params: Params = {"layers": layers}
    dt = cfg.dtype
    mapping = {
        "input_layernorm.weight": ("attn_norm", False),
        "post_attention_layernorm.weight": ("post_attn_norm", False),
        "pre_feedforward_layernorm.weight": ("pre_mlp_norm", False),
        "post_feedforward_layernorm.weight": ("post_mlp_norm", False),
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "self_attn.q_norm.weight": ("q_norm", False),
        "self_attn.k_norm.weight": ("k_norm", False),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
    }
    for name, w in read_safetensors(path, device):
        name = name.removeprefix("language_model.")
        layer = _split_layer_name(name)
        if name == "model.embed_tokens.weight":
            params["embed"] = _put(w, dt)
        elif name == "model.norm.weight":
            params["final_norm"] = _put(w, dt)
        elif name == "lm_head.weight":
            # an untied finetune: lm_logits prefers lm_head over embed.T
            params["lm_head"] = _put(w, dt, True)
        elif layer is not None and layer[1] in mapping:
            ours, transpose = mapping[layer[1]]
            layers[layer[0]][ours] = _put(w, dt, transpose)
        else:
            log.debug("ignoring unmapped tensor %s", name)
        del w
    if not cfg.tie_embeddings and "lm_head" not in params:
        raise ValueError(
            f"checkpoint at {path} has tie_word_embeddings=false but no lm_head.weight")
    missing = [i for i, lp in enumerate(layers) if "wq" not in lp]
    if missing:
        raise ValueError(f"checkpoint at {path} missing layers {missing[:4]}...")
    log.info("loaded %d gemma layers from %s", cfg.num_layers, path)
    return params


def _load_params_mla(path: str, cfg: MlaConfig, device: torch.device) -> Params:
    """HF DeepSeek V2/V3 tensors -> the MLA parameters.

    kv_b_proj [heads * (nope + v), rank] splits into the absorbed per-head
    up-projections: rows [:nope] -> w_uk [h, nope, rank], rows [nope:] ->
    w_uv [h, rank, v] (transposed). Rope output rows of q(_b)_proj and
    kv_a_proj_with_mqa are de-interleaved (``_deinterleave_rope_rows``).
    Routed experts are stacked into [E, in, out] per layer and projection
    as soon as the last of them arrives, and their loose copies dropped."""
    layers: list = [dict() for _ in range(cfg.num_layers)]
    params: Params = {"layers": layers}
    dt = cfg.dtype
    nope, rope, vd = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    nh, rank = cfg.num_heads, cfg.kv_lora_rank
    stacks = (("gate_proj", "w_egate"), ("up_proj", "w_eup"), ("down_proj", "w_edown"))
    # layer -> projection -> {expert: [out, in] tensor} until complete; the
    # projections stacked so far, per layer (layers in first-seen order)
    pending: Dict[int, Dict[str, Dict[int, torch.Tensor]]] = {}
    stacked: Dict[int, set] = {}

    def deint(w: torch.Tensor, pre: int, heads: int) -> torch.Tensor:
        return _deinterleave_rope_rows(w, pre, rope, heads) if cfg.rope_interleave else w

    simple = {
        "input_layernorm.weight": ("attn_norm", False),
        "post_attention_layernorm.weight": ("mlp_norm", False),
        "self_attn.q_a_layernorm.weight": ("q_norm", False),
        "self_attn.kv_a_layernorm.weight": ("kv_norm", False),
        "self_attn.q_a_proj.weight": ("w_dq", True),
        "self_attn.o_proj.weight": ("wo", True),
        "mlp.gate_proj.weight": ("w_gate", True),
        "mlp.up_proj.weight": ("w_up", True),
        "mlp.down_proj.weight": ("w_down", True),
        "mlp.shared_experts.gate_proj.weight": ("w_shared_gate", True),
        "mlp.shared_experts.up_proj.weight": ("w_shared_up", True),
        "mlp.shared_experts.down_proj.weight": ("w_shared_down", True),
        "mlp.gate.weight": ("w_router", True),
    }
    for name, w in read_safetensors(path, device):
        layer = _split_layer_name(name)
        if name == "model.embed_tokens.weight":
            params["embed"] = _put(w, dt)
        elif name == "model.norm.weight":
            params["final_norm"] = _put(w, dt)
        elif name == "lm_head.weight":
            params["lm_head"] = _put(w, dt, True)
        elif layer is None:
            log.debug("ignoring unmapped tensor %s", name)
        else:
            li, rest = layer
            lp = layers[li]
            parts = rest.split(".")
            if rest in simple:
                ours, transpose = simple[rest]
                lp[ours] = _put(w, dt, transpose)
            elif rest == "mlp.gate.e_score_correction_bias":
                lp["router_bias"] = _put(w, torch.float32)
            elif rest in ("self_attn.q_proj.weight", "self_attn.q_b_proj.weight"):
                ours = "wq" if rest == "self_attn.q_proj.weight" else "w_uq"
                lp[ours] = _put(deint(w, nope, nh), dt, True)
            elif rest == "self_attn.kv_a_proj_with_mqa.weight":
                # out rows = [latent (rank) | k_pe (rope)]: one "head" of rope
                lp["w_dkv"] = _put(deint(w, rank, 1), dt, True)
            elif rest == "self_attn.kv_b_proj.weight":
                kvb = w.reshape(nh, nope + vd, rank)
                lp["w_uk"] = _put(kvb[:, :nope, :], dt)
                lp["w_uv"] = _put(kvb[:, nope:, :].transpose(1, 2), dt)
                del kvb
            elif parts[:2] == ["mlp", "experts"] and len(parts) > 3:
                ei, pname = int(parts[2]), parts[3]
                group = pending.setdefault(li, {}).setdefault(pname, {})
                group[ei] = w
                stacked.setdefault(li, set())
                ours = dict(stacks).get(pname)
                if ours is not None and len(group) == cfg.num_experts:
                    lp[ours] = _put(torch.stack(
                        [group[e].t() for e in range(cfg.num_experts)]), dt)
                    del pending[li][pname]
                    stacked[li].add(pname)
            else:
                log.debug("ignoring unmapped tensor %s", name)
        del w
    for li in stacked:
        for pname, _ in stacks:
            if pname not in stacked[li]:
                have = len(pending.get(li, {}).get(pname, {}))
                raise ValueError(f"layer {li}: {have}/{cfg.num_experts} "
                                 f"{pname} expert shards in checkpoint")
    missing = [i for i, lp in enumerate(layers)
               if ("wq" not in lp and "w_uq" not in lp) or "w_dkv" not in lp]
    if missing:
        raise ValueError(f"checkpoint at {path} missing MLA layers {missing[:4]}...")
    log.info("loaded %d MLA layers from %s", cfg.num_layers, path)
    return params


# OCP MXFP4 e2m1 value table (public microscaling spec; also
# transformers.integrations.mxfp4.FP4_VALUES)
FP4_VALUES = (
    +0.0, +0.5, +1.0, +1.5, +2.0, +3.0, +4.0, +6.0,
    -0.0, -0.5, -1.0, -1.5, -2.0, -3.0, -4.0, -6.0,
)


def mxfp4_table() -> np.ndarray:
    """[256, 16] float32: the value of nibble n under scale byte s, in the
    reference's arithmetic (the float32 FP4 value times ``2 ** (s - 127)``
    in float64, rounded once to float32: byte 255 times 0.5 is 2**127,
    times 6 is inf; bytes 0-1 give subnormals; zeros stay signed zeros)."""
    lut = np.asarray(FP4_VALUES, np.float32)
    scale = np.exp2(np.arange(256, dtype=np.int32) - 127)
    with np.errstate(over="ignore"):
        return (lut[None, :] * scale[:, None]).astype(np.float32)


def dequant_mxfp4(blocks: torch.Tensor, scales: torch.Tensor) -> torch.Tensor:
    """Dequantize MXFP4 expert weights on their device: ``blocks`` uint8
    [E, out, G, B] pack two FP4 e2m1 nibbles per byte (low nibble first),
    ``scales`` uint8 [E, out, G] are e8m0 block exponents (bias 127).
    Returns contiguous float32 [E, in, out] (in = G * B * 2), bit-equal to
    the reference's numpy dequant: each value is one lookup in
    ``mxfp4_table``. One expert at a time, so the index tensors stay
    small."""
    E, O, G, B = blocks.shape
    if tuple(scales.shape) != (E, O, G):
        raise ValueError(f"scales {tuple(scales.shape)} do not match blocks "
                         f"{tuple(blocks.shape)}")
    table = torch.from_numpy(mxfp4_table()).reshape(-1).to(blocks.device)
    out = torch.empty(E, G * B * 2, O, dtype=torch.float32, device=blocks.device)
    for e in range(E):
        b = blocks[e].long()
        s = scales[e].long()[..., None] << 4                   # [O, G, 1]
        idx = torch.stack([s | (b & 0x0F), s | (b >> 4)], dim=-1)
        out[e] = table[idx].reshape(O, -1).t()
    return out


def _load_params_gptoss(path: str, cfg: GptOssConfig, device: torch.device) -> Params:
    """HF gpt-oss tensors -> the gpt-oss parameters. The fused per-expert
    projections (mlp.experts.gate_up_proj [E, H, 2I], down_proj [E, I, H])
    are stored input-major, so they load untransposed; gate/up lanes stay
    interleaved. An MXFP4 release is dequantized on the device the moment
    both halves of a tensor have arrived, and the halves dropped."""
    layers: list = [dict() for _ in range(cfg.num_layers)]
    params: Params = {"layers": layers}
    dt = cfg.dtype
    mapping = {
        "input_layernorm.weight": ("attn_norm", False),
        "post_attention_layernorm.weight": ("mlp_norm", False),
        "self_attn.q_proj.weight": ("wq", True),
        "self_attn.k_proj.weight": ("wk", True),
        "self_attn.v_proj.weight": ("wv", True),
        "self_attn.o_proj.weight": ("wo", True),
        "self_attn.q_proj.bias": ("bq", False),
        "self_attn.k_proj.bias": ("bk", False),
        "self_attn.v_proj.bias": ("bv", False),
        "self_attn.o_proj.bias": ("bo", False),
        "mlp.router.weight": ("w_router", True),
        "mlp.router.bias": ("b_router", False),
        "mlp.experts.gate_up_proj": ("w_gateup", False),
        "mlp.experts.gate_up_proj_bias": ("b_gateup", False),
        "mlp.experts.down_proj": ("w_edown", False),
        "mlp.experts.down_proj_bias": ("b_edown", False),
    }
    mx: Dict[int, Dict[str, torch.Tensor]] = {}
    for name, w in read_safetensors(path, device):
        layer = _split_layer_name(name)
        if name == "model.embed_tokens.weight":
            params["embed"] = _put(w, dt)
        elif name == "model.norm.weight":
            params["final_norm"] = _put(w, dt)
        elif name == "lm_head.weight":
            params["lm_head"] = _put(w, dt, True)
        elif layer is None:
            log.debug("ignoring unmapped tensor %s", name)
        else:
            li, rest = layer
            if rest == "self_attn.sinks":
                layers[li]["sinks"] = _put(w, torch.float32)
            elif rest in mapping:
                ours, transpose = mapping[rest]
                layers[li][ours] = _put(w, dt, transpose)
            elif rest.startswith("mlp.experts.") and rest.endswith(("_blocks", "_scales")):
                part = rest.removeprefix("mlp.experts.")
                lay = mx.setdefault(li, {})
                lay[part] = w
                base = part.rsplit("_", 1)[0]
                b, sc = lay.get(f"{base}_blocks"), lay.get(f"{base}_scales")
                if b is not None and sc is not None:
                    ours = {"gate_up_proj": "w_gateup", "down_proj": "w_edown"}[base]
                    layers[li][ours] = dequant_mxfp4(b, sc).to(dt)
                    del lay[f"{base}_blocks"], lay[f"{base}_scales"], b, sc
            else:
                log.debug("ignoring unmapped tensor %s", name)
        del w
    for li, parts_d in mx.items():
        if parts_d:  # an unpaired half: a truncated or corrupt checkpoint
            raise ValueError(
                f"layer {li}: MXFP4 tensors missing their other half: {sorted(parts_d)}")
    missing = [i for i, lp in enumerate(layers)
               if "wq" not in lp or "sinks" not in lp or "w_gateup" not in lp]
    if missing:
        raise ValueError(f"checkpoint at {path} missing gpt-oss layers {missing[:4]}...")
    log.info("loaded %d gpt-oss layers from %s", cfg.num_layers, path)
    return params
