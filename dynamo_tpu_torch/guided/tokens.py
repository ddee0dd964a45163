"""DFA x tokenizer-vocabulary product tables for on-device guided masking.

The byte-level DFA (guided/regex.py) is lifted to TOKEN granularity: for
every DFA state s and token t, walking t's bytes from s either rejects or
lands in a state — a [S, V] table. Stored compressed for the device:

- tokens with identical transition COLUMNS collapse into classes:
  ``class_of`` [V] int32 and ``trans`` [S, C] int32 (-1 = reject). C is
  small (tokens inside a JSON string mostly behave identically), so the
  per-slot device cost is one [V] class map + one [S, C] table instead of
  [S, V].
- EOS is its own class: allowed exactly at accepting states (emitting EOS
  finishes the constrained text); all other special tokens are rejected
  everywhere. At accepting DEAD-END states (match complete, no byte can
  extend it) EOS is the only allowed class, which forces termination.

The engine gathers ``trans[state]`` -> [C] and indexes it by ``class_of``
to mask logits each step, then steps the state with the sampled token
(engine/sampling.py ``guided_mask`` / ``guided_step``), on device tensors
only, so guided rows ride the normal decode horizons and their CUDA graphs
with no host round trip.

The vectorized product walk processes all (state, token) pairs one byte
position at a time with numpy gathers, so cost is O(max_token_len) table
gathers, not a Python loop over V*S.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .regex import Dfa


@dataclasses.dataclass
class TokenTables:
    """Compressed token-level automaton for one grammar x one vocabulary."""

    class_of: np.ndarray      # [V] int32 token -> class
    trans: np.ndarray         # [S, C] int32 next state or -1
    accept: np.ndarray        # [S] bool (accepting byte-states)
    eos_id: int

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]

    @property
    def num_classes(self) -> int:
        return self.trans.shape[1]

    def allowed(self, state: int) -> np.ndarray:
        """[V] bool mask of tokens legal from ``state`` (host-side view)."""
        return self.trans[state][self.class_of] >= 0

    def step(self, state: int, token: int) -> int:
        """Host-side replay of the device transition (engine resync after a
        horizon is applied)."""
        nxt = int(self.trans[state, self.class_of[token]])
        if nxt < 0:
            raise ValueError(f"token {token} not allowed from state {state}")
        return nxt

    def walk(self, state: int, tokens: Sequence[int]) -> int:
        for t in tokens:
            state = self.step(state, t)
        return state


def build_token_tables(
    dfa: Dfa,
    vocab: List[Optional[bytes]],
    eos_id: int,
) -> TokenTables:
    """Product-construct the token tables.

    ``vocab[t]`` is token t's exact byte contribution, or None for special/
    untextual tokens (rejected everywhere). ``eos_id`` is handled per the
    module docstring."""
    S = dfa.num_states
    V = len(vocab)
    maxlen = max((len(b) for b in vocab if b), default=1)

    # byte matrix [V, maxlen] padded with -1
    bytes_mat = np.full((V, maxlen), -1, np.int32)
    lens = np.zeros(V, np.int32)
    special = np.zeros(V, bool)
    for t, b in enumerate(vocab):
        if b is None:
            special[t] = True
            continue
        if len(b) == 0:
            # zero-byte tokens would self-loop without consuming grammar:
            # reject them under guidance
            special[t] = True
            continue
        lens[t] = len(b)
        bytes_mat[t, : len(b)] = np.frombuffer(b, np.uint8).astype(np.int32)

    # full product [S, V]: iterate byte positions, gathering through the DFA
    state = np.broadcast_to(
        np.arange(S, dtype=np.int32)[:, None], (S, V)
    ).copy()
    for p in range(maxlen):
        col = bytes_mat[:, p]                      # [V]
        active = (col >= 0)[None, :] & (state >= 0)  # tokens this long, alive
        idx_state = np.where(state >= 0, state, 0)
        nxt = dfa.trans[idx_state, np.clip(col, 0, 255)[None, :]]
        state = np.where(active, nxt, state)
    full = np.where(special[None, :], -1, state)   # [S, V] int32
    full[:, eos_id] = np.where(dfa.accept, _EOS_SENTINEL, -1)

    # compress identical columns into classes
    cols = np.ascontiguousarray(full.T)            # [V, S]
    uniq, inverse = np.unique(cols, axis=0, return_inverse=True)
    class_of = inverse.astype(np.int32)
    trans = np.ascontiguousarray(uniq.T).astype(np.int32)  # [S, C]
    return TokenTables(
        class_of=class_of, trans=trans, accept=dfa.accept.copy(),
        eos_id=eos_id,
    )


# EOS "next state" sentinel: after EOS the engine stops; any valid state id
# works. Use 0 so the table stays within [0, S).
_EOS_SENTINEL = 0


# --------------------------------------------------- vocabulary byte forms


def vocab_bytes_from_tokenizer(tok) -> Tuple[List[Optional[bytes]], int]:
    """(vocab byte forms, eos_id) for one of the port's tokenizers
    (llm/tokenizer.py ByteTokenizer / HFTokenizer): the exact byte
    contribution per token id.

    - byte tokenizer: id == byte value; specials (>=256) map to None.
    - HF tokenizers: GPT-2 byte-level alphabet decoded per token piece
      (Ġ -> space etc.); SentencePiece-style pieces handle ▁ and <0xXX>
      byte-fallback forms. Special tokens map to None (rejected under
      guidance)."""
    eos_id = getattr(tok, "eos_token_id", None)
    hf = getattr(tok, "_tok", None)  # HFTokenizer wraps transformers here
    if hf is None:
        # byte-level tokenizer: ids 0-255 are literal bytes
        size = int(getattr(tok, "vocab_size", 512))
        out: List[Optional[bytes]] = [
            bytes([i]) if i < 256 else None for i in range(size)
        ]
        return out, int(eos_id if eos_id is not None else 257)

    size = len(hf)
    specials = set(getattr(hf, "all_special_ids", []) or [])
    byte_decoder = _gpt2_byte_decoder()
    out = []
    for i in range(size):
        if i in specials:
            out.append(None)
            continue
        piece = hf.convert_ids_to_tokens(i)
        if piece is None:
            out.append(None)
            continue
        out.append(_piece_bytes(piece, byte_decoder))
    if eos_id is None:
        eos_id = getattr(hf, "eos_token_id", None)
    if eos_id is None:
        raise ValueError("tokenizer has no EOS id; guided decoding needs one")
    return out, int(eos_id)


def _piece_bytes(piece: str, byte_decoder: Dict[str, int]) -> Optional[bytes]:
    # SentencePiece byte-fallback tokens: "<0x0A>"
    if len(piece) == 6 and piece.startswith("<0x") and piece.endswith(">"):
        try:
            return bytes([int(piece[3:5], 16)])
        except ValueError:
            pass
    # GPT-2 byte-level alphabet: every char maps back to one byte
    if all(c in byte_decoder for c in piece):
        return bytes(byte_decoder[c] for c in piece)
    # SentencePiece visible-space convention
    return piece.replace("▁", " ").encode("utf-8")


def _gpt2_byte_decoder() -> Dict[str, int]:
    """The byte<->unicode alphabet used by GPT-2-style byte-level BPE
    (public construction: printable bytes map to themselves, the rest to
    U+0100.. offsets)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {chr(c): b for b, c in zip(bs, cs)}
