"""Device resolution and the dtype map of the port.

Entry points run on the GPU by default. ``resolve_device(None)`` returns
``cuda`` and raises when no CUDA device is present: a caller that wants the
CPU (the tests, a CPU smoke run) asks for ``"cpu"`` explicitly. Nothing here
ever drops to the CPU silently.
"""

from __future__ import annotations

from typing import Union

import torch

# configuration names -> torch dtypes (the JAX package's model dtypes)
DTYPES = {
    "bf16": torch.bfloat16,
    "bfloat16": torch.bfloat16,
    "f32": torch.float32,
    "float32": torch.float32,
}

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; an explicit device is taken as given. Raises
    when CUDA is asked for (explicitly or by default) but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    return dev


def resolve_dtype(dtype: Union[str, torch.dtype]) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    try:
        return DTYPES[dtype]
    except KeyError:
        raise ValueError(
            f"unknown dtype {dtype!r} (expected one of {sorted(DTYPES)})"
        ) from None
