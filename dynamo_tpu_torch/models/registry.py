"""Model-family registry: one place that maps a model config to its
family's (init, forward, lm_logits) functions and parameter names, so the
engine stays family-agnostic. Counterpart of the reference's
models/registry.py for the families the port has (llama, gemma, gpt-oss).
"""

from __future__ import annotations

from typing import Callable, Dict

from . import gemma, gptoss, llama

# preset name -> config constructor, every family's
PRESETS: Dict[str, Callable[[], llama.LlamaConfig]] = {
    **llama.PRESETS, **gemma.PRESETS, **gptoss.PRESETS}


def is_gemma(cfg) -> bool:
    return isinstance(cfg, gemma.GemmaConfig)


def is_gptoss(cfg) -> bool:
    return isinstance(cfg, gptoss.GptOssConfig)


def family(cfg):
    if is_gptoss(cfg):
        return gptoss
    return gemma if is_gemma(cfg) else llama


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
    (gpt-oss's sinks)."""
    return gptoss.FLOAT32_KEYS if is_gptoss(cfg) else ()
