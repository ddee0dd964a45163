"""Model-family registry: one place that maps a model config to its
family's (init, forward, lm_logits) functions and parameter names, so the
engine stays family-agnostic. Counterpart of the reference's
models/registry.py for the families the port has (llama, gemma, gpt-oss,
Qwen3-MoE and the DeepSeek MLA family).
"""

from __future__ import annotations

from typing import Callable, Dict

from . import gemma, gptoss, llama, mla, moe

# preset name -> config constructor, every family's
PRESETS: Dict[str, Callable[[], llama.LlamaConfig]] = {
    **llama.PRESETS, **gemma.PRESETS, **gptoss.PRESETS, **moe.PRESETS, **mla.PRESETS}


def is_gemma(cfg) -> bool:
    return isinstance(cfg, gemma.GemmaConfig)


def is_gptoss(cfg) -> bool:
    return isinstance(cfg, gptoss.GptOssConfig)


def is_moe(cfg) -> bool:
    return isinstance(cfg, moe.MoeConfig)


def is_mla(cfg) -> bool:
    return isinstance(cfg, mla.MlaConfig)


def family(cfg):
    for test, module in ((is_gptoss, gptoss), (is_mla, mla), (is_moe, moe),
                         (is_gemma, gemma)):
        if test(cfg):
            return module
    return llama


def init_params(cfg, generator, device=None):
    return family(cfg).init_params(cfg, generator, device)


def forward_fn(cfg):
    return family(cfg).forward


def lm_logits_fn(cfg):
    return family(cfg).lm_logits


def layer_keys(cfg):
    return family(cfg).LAYER_KEYS


def float32_keys(cfg):
    """Per-layer parameters kept in float32 whatever the model dtype
    (gpt-oss's sinks, MLA's router bias)."""
    return getattr(family(cfg), "FLOAT32_KEYS", ())
