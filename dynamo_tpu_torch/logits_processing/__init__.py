"""Pluggable logits processors on device tensors.

Counterpart of the reference's dynamo_tpu/logits_processing: a processor is
a pure function ``fn(logits, state) -> logits`` over the whole batch
(``logits: [B, V]`` float32); ``state`` holds device tensors
(``output_counts [B, V]``, ``steps [B]``, ``seq_lens [B]``). Processors are
registered at engine build (``TorchEngineConfig.logits_processors``, a
tuple of ``(name, fn)``); a request opts in by name (annotation
``logits_processors: [names...]``), and the engine applies
``where(mask, fn(logits), logits)`` with one ``[B]`` mask per processor.

The reference skips a processor no row asked for with a
``lax.cond(any(mask))``. A CUDA graph cannot branch on data, so the port
decides that on the host, which knows every slot's mask at dispatch: the
eager steps pass only the processors some row opted into, and the decode
horizon replays its feature graph (every processor under its mask) only
when a row of the dispatch uses a feature (engine/graphs.py). A processor
must therefore be graph-safe: device tensors only, no host reads.
"""

from __future__ import annotations

from typing import Callable, Dict, Protocol, Sequence, Tuple, runtime_checkable

import torch

NEG_INF = -1e30


@runtime_checkable
class BaseLogitsProcessor(Protocol):
    """``fn(logits [B, V] f32, state dict) -> logits``: pure, graph-safe.

    ``state`` keys: ``output_counts`` [B, V] int32, ``steps`` [B] (tokens
    produced so far), ``seq_lens`` [B]."""

    def __call__(self, logits: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        ...


def apply_processors(
    processors: Sequence[Tuple[str, Callable]],
    masks: torch.Tensor,            # [B, n_procs] bool: per-slot opt-in
    logits: torch.Tensor,           # [B, V] float32
    state: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Apply each processor to its subscribing rows only: column k of
    ``masks`` selects the rows of ``processors[k]``."""
    for k, (_name, fn) in enumerate(processors):
        logits = torch.where(masks[:, k, None], fn(logits, state), logits)
    return logits


# ---------------------------------------------------------------------------
# example processors (the reference's examples)
# ---------------------------------------------------------------------------


def temperature_processor(temperature: float) -> Callable:
    """Extra temperature scaling ahead of the sampler."""
    if temperature <= 0:
        raise ValueError("temperature must be positive")

    def fn(logits: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        return logits / temperature

    return fn


def ban_tokens_processor(token_ids) -> Callable:
    """Hard-mask a fixed token set (the classic bad-words filter). The ids
    move to a device once, on the first call there (an engine runs its
    bodies once before capturing them)."""
    ids = torch.as_tensor(list(token_ids), dtype=torch.long)
    on_device: Dict[torch.device, torch.Tensor] = {}

    def fn(logits: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        dev = logits.device
        if dev not in on_device:
            on_device[dev] = ids.to(dev)
        return logits.index_fill(1, on_device[dev], NEG_INF)

    return fn


def repetition_window_processor(penalty: float) -> Callable:
    """Down-weight every token already generated (reads the on-device
    output counts)."""

    def fn(logits: torch.Tensor, state: Dict[str, torch.Tensor]) -> torch.Tensor:
        seen = state["output_counts"] > 0
        return torch.where(seen, logits - penalty, logits)

    return fn
