"""Batched multi-LoRA: device-resident adapter tables, slot-indexed apply.

Counterpart of the reference's dynamo_tpu/lora/adapters.py:

- All adapters live in stacked tables ``A[name]: [N, L, in, r]`` /
  ``B[name]: [N, L, r, out]`` allocated once at engine build. Loading
  adapter ``i`` writes slot ``i`` of those tensors in place (``copy_``), so
  every tensor keeps its address: the decode horizon's CUDA graphs, which
  hold addresses, see a load at their next replay with no recapture.
- Slot 0 is the identity (zero tables), so a base-model row in a batch
  with adapter rows costs zero products instead of a branch.
- ``make_lora_fn`` gives ``llama.forward`` the delta of each target
  projection, in three input forms: one adapter for ``[S, H]`` (a prefill
  chunk), one adapter per slot for ``[B, S, H]`` (a decode batch, each
  slot's tables gathered once per forward for every layer, then ``bmm``),
  and a packed ``[T, H]`` buffer of segments (the fused mixed step: the
  chunk's rows with one adapter, then one decode row per slot). The
  reference gathers the packed form's tables per token, which XLA fuses;
  materialised in PyTorch that is ``[T, in, r]`` per target and layer, so
  the port never builds it.
- Each load also records a digest of the adapter's weights, which the
  engine mixes into an adapter request's prefix-cache block hashes
  (``cache_key``): KV computed under one adapter, or under the base model,
  never serves another.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

log = logging.getLogger("dynamo_tpu_torch.lora")

# projection output / input sizes by target name, resolved from the model config
_TARGET_OUT = {
    "wq": lambda cfg: cfg.q_size,
    "wk": lambda cfg: cfg.kv_size,
    "wv": lambda cfg: cfg.kv_size,
    "wo": lambda cfg: cfg.hidden_size,
    "w_gate": lambda cfg: cfg.intermediate_size,
    "w_up": lambda cfg: cfg.intermediate_size,
    "w_down": lambda cfg: cfg.hidden_size,
}
_TARGET_IN = {
    "wq": lambda cfg: cfg.hidden_size,
    "wk": lambda cfg: cfg.hidden_size,
    "wv": lambda cfg: cfg.hidden_size,
    "wo": lambda cfg: cfg.q_size,
    "w_gate": lambda cfg: cfg.hidden_size,
    "w_up": lambda cfg: cfg.hidden_size,
    "w_down": lambda cfg: cfg.intermediate_size,
}


class LoraAdapterTable:
    """N-slot adapter store + name registry. Slot 0 = identity (no adapter)."""

    def __init__(
        self,
        model_cfg,
        max_adapters: int = 8,
        rank: int = 16,
        targets: Sequence[str] = ("wq", "wk", "wv", "wo"),
        dtype: torch.dtype = torch.bfloat16,
        device=None,
    ):
        for t in targets:
            if t not in _TARGET_OUT:
                raise ValueError(f"unknown LoRA target {t!r}")
        self.cfg = model_cfg
        self.max_adapters = max_adapters
        self.rank = rank
        self.targets = tuple(targets)
        self.dtype = dtype
        self.device = torch.device(device or "cpu")
        N, L, r = max_adapters + 1, model_cfg.num_layers, rank
        self.A: Dict[str, torch.Tensor] = {}
        self.B: Dict[str, torch.Tensor] = {}
        for t in self.targets:
            self.A[t] = torch.zeros((N, L, _TARGET_IN[t](model_cfg), r), dtype=dtype,
                                    device=self.device)
            self.B[t] = torch.zeros((N, L, r, _TARGET_OUT[t](model_cfg)), dtype=dtype,
                                    device=self.device)
        self.scales = torch.zeros((N,), dtype=torch.float32, device=self.device)
        self._names: List[Optional[str]] = [None] * N  # slot -> adapter name
        self._keys: List[Optional[bytes]] = [None] * N  # slot -> prefix-cache salt
        self._loading: Dict[str, int] = {}  # name -> reserved slot (in-flight)
        self._lock = threading.Lock()

    # -- registry ------------------------------------------------------------
    def slot_of(self, name: Optional[str]) -> int:
        """Adapter slot for a name; 0 (identity) when absent/None."""
        if not name:
            return 0
        with self._lock:
            try:
                return self._names.index(name)
            except ValueError:
                return 0

    def list_adapters(self) -> List[str]:
        with self._lock:
            return [n for n in self._names[1:] if n]

    def cache_key(self, name: Optional[str]) -> Optional[bytes]:
        """The prefix-cache salt of a loaded adapter: its name and a digest
        of the weights of its current load (None for the base model or an
        unknown name). A reload under the same name with other weights gets
        another key, so the old weights' blocks never match."""
        slot = self.slot_of(name)
        return self._keys[slot] if slot else None

    def key_map(self) -> Dict[str, str]:
        """{name: cache_key hex} of every loaded adapter: what a KV router
        needs to hash an adapter request as this table's engine does."""
        with self._lock:
            return {n: k.hex() for n, k in zip(self._names, self._keys)
                    if isinstance(n, str) and k is not None}

    # -- lifecycle -----------------------------------------------------------
    def load(
        self,
        name: str,
        weights: Dict[str, np.ndarray],
        alpha: Optional[float] = None,
    ) -> int:
        """Install adapter weights into a free slot (in place: every table
        keeps its address). ``weights`` maps ``"<target>.A"``/``"<target>.B"``
        to per-layer stacks [L, in, r] / [L, r, out]. Returns the slot id."""
        reserved = object()  # placeholder: slot taken, name not yet visible
        with self._lock:
            if name in self._names:
                slot = self._names.index(name)
            elif name in self._loading:
                # concurrent load of the same name reuses the reserved slot
                # (last writer wins on the tables; no second slot leaks)
                slot = self._loading[name]
            else:
                try:
                    slot = self._names.index(None, 1)
                except ValueError:
                    raise RuntimeError(
                        f"no free adapter slots (max {self.max_adapters})"
                    ) from None
                self._names[slot] = reserved  # type: ignore[assignment]
                self._loading[name] = slot
        # adapter rank = rank of the PROVIDED matrices (absent targets are
        # zero-filled at table rank and must not influence the scale)
        ranks = {
            weights[f"{t}.A"].shape[-1]
            for t in self.targets if f"{t}.A" in weights
        }
        r_eff = ranks.pop() if len(ranks) == 1 else self.rank
        digest = hashlib.blake2b(digest_size=16)
        try:
            for t in self.targets:
                a = weights.get(f"{t}.A")
                b = weights.get(f"{t}.B")
                if a is None or b is None:
                    # target absent in this adapter: identity (zeros)
                    a = np.zeros(self.A[t].shape[1:], np.float32)
                    b = np.zeros(self.B[t].shape[1:], np.float32)
                a, b = self._fit_rank(np.asarray(a), np.asarray(b))
                for table, w in ((self.A[t], a), (self.B[t], b)):
                    w = torch.from_numpy(np.ascontiguousarray(w)).to(self.dtype)
                    table[slot].copy_(w)
                    digest.update(t.encode())
                    digest.update(w.view(torch.uint8).numpy())
            scale = (alpha if alpha is not None else float(r_eff)) / float(r_eff)
            self.scales[slot] = scale
            digest.update(np.float32(scale).tobytes())
        except Exception:
            with self._lock:
                if self._loading.get(name) == slot:
                    del self._loading[name]
                    if not isinstance(self._names[slot], str):
                        self._names[slot] = None  # release the reserved slot
            raise
        # the name becomes routable only now, with every table written —
        # a request racing the load sees "unknown adapter", never zeros
        with self._lock:
            self._names[slot] = name
            self._keys[slot] = b"lora\x00" + name.encode() + b"\x00" + digest.digest()
            self._loading.pop(name, None)
        log.info("lora adapter %r loaded into slot %d (scale %.3f)", name, slot, scale)
        return slot

    def _fit_rank(self, a: np.ndarray, b: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Pad (or reject) adapter rank into the static table rank."""
        r = a.shape[-1]
        if r > self.rank:
            raise ValueError(f"adapter rank {r} exceeds table rank {self.rank}")
        if r < self.rank:
            pad_a = np.zeros((*a.shape[:-1], self.rank - r), a.dtype)
            a = np.concatenate([a, pad_a], axis=-1)
            pad_b = np.zeros((*b.shape[:-2], self.rank - r, b.shape[-1]), b.dtype)
            b = np.concatenate([b, pad_b], axis=-2)
        return a, b

    def unload(self, name: str) -> bool:
        with self._lock:
            if name not in self._names:
                return False
            slot = self._names.index(name)
            self._names[slot] = None
            self._keys[slot] = None
        for t in self.targets:
            self.A[t][slot].zero_()
            self.B[t][slot].zero_()
        self.scales[slot] = 0.0
        log.info("lora adapter %r unloaded from slot %d", name, slot)
        return True

    # -- forward inputs ------------------------------------------------------
    def tables(self) -> Dict[str, torch.Tensor]:
        """The tables as ``make_lora_fn`` takes them: the same tensors on
        every call (loads write them in place)."""
        out: Dict[str, torch.Tensor] = {"scales": self.scales}
        for t in self.targets:
            out[f"{t}.A"] = self.A[t]
            out[f"{t}.B"] = self.B[t]
        return out


@dataclasses.dataclass(frozen=True)
class PackedAdapterIds:
    """The adapter ids of a packed ``[T, H]`` buffer, as its segments: the
    first ``head_len`` tokens (a prefill chunk) use adapter ``head_id``, and
    each of the remaining ``T - head_len`` tokens is one decode row whose
    adapter is ``rows[i]`` ([T - head_len] device tensor)."""

    head_len: int
    head_id: int
    rows: torch.Tensor


AdapterIds = Union[int, torch.Tensor, PackedAdapterIds]


def make_lora_fn(tables: Dict[str, torch.Tensor],
                 adapter_ids: AdapterIds) -> Callable:
    """``lora(name, layer_idx, x) -> delta or None`` for llama.forward.

    ``adapter_ids``: an int (or 0-d tensor) for one adapter over any
    activations (a prefill chunk, ``[S, H]``); a [B] tensor for a decode
    batch (``[B, S, H]`` activations, one adapter per slot); or a
    ``PackedAdapterIds`` for the mixed step's ``[T, H]`` buffer. The delta
    is ``((x @ A) @ B) * scale`` in x's dtype, the scale applied in
    float32, as the reference's."""
    scales = tables["scales"]
    gathered: Dict[str, torch.Tensor] = {}

    def slot_tables(key: str, ids: torch.Tensor) -> torch.Tensor:
        # each slot's tables for every layer, gathered once per forward
        if key not in gathered:
            gathered[key] = tables[key].index_select(0, ids.long())
        return gathered[key]

    def per_slot(key_a: str, key_b: str, layer_idx: int, x: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
        # x [B, S, in] with B = len(ids)
        A = slot_tables(key_a, ids)[:, layer_idx]      # [B, in, r]
        Bm = slot_tables(key_b, ids)[:, layer_idx]     # [B, r, out]
        if "scales/slots" not in gathered:
            gathered["scales/slots"] = scales.index_select(0, ids.long())
        s = gathered["scales/slots"][:, None, None]
        # a model-dtype product times the float32 [B, 1, 1] scales computes
        # in float32 (type promotion), as the reference's; one launch less
        # than casting first, and the same bits
        return (torch.bmm(torch.bmm(x, A), Bm) * s).to(x.dtype)

    def one(key_a: str, key_b: str, layer_idx: int, x: torch.Tensor,
            idx) -> torch.Tensor:
        xa = x @ tables[key_a][idx, layer_idx]
        return ((xa @ tables[key_b][idx, layer_idx]).float() * scales[idx]).to(x.dtype)

    def lora(name: str, layer_idx: int, x: torch.Tensor) -> Optional[torch.Tensor]:
        a_key, b_key = f"{name}.A", f"{name}.B"
        if a_key not in tables:
            return None
        if isinstance(adapter_ids, PackedAdapterIds):
            p = adapter_ids
            head = one(a_key, b_key, layer_idx, x[:p.head_len], p.head_id)
            rows = per_slot(a_key, b_key, layer_idx, x[p.head_len:, None], p.rows)
            return torch.cat([head, rows[:, 0]])
        if isinstance(adapter_ids, int) or adapter_ids.ndim == 0:
            return one(a_key, b_key, layer_idx, x, adapter_ids)
        return per_slot(a_key, b_key, layer_idx, x, adapter_ids)

    return lora
