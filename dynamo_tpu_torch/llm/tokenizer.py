"""Tokenizers and incremental detokenization.

Counterparts of the reference package's llm/tokenizer.py:

- ``ByteTokenizer``: UTF-8 bytes as tokens (ids 256+ are special tokens),
  exact text round trip, no assets; the default for presets and tests.
- ``HFTokenizer``: ``transformers.AutoTokenizer`` over a local checkpoint
  directory, with the model's own chat template. ``transformers`` is
  imported when one is built, never with this module.
- ``load_tokenizer`` picks one by reference, ``DecodeStream`` turns token
  ids into printable text deltas over either.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, Iterable, List, Optional, Protocol, Sequence

log = logging.getLogger("dynamo_tpu_torch.llm.tokenizer")


class Tokenizer(Protocol):
    eos_token_id: int
    bos_token_id: Optional[int]
    vocab_size: int

    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str: ...

    def apply_chat_template(
        self, messages: List[Dict[str, Any]], add_generation_prompt: bool = True
    ) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes as tokens; ids 256+ are special tokens.

    vocab_size is padded to 512 (a multiple of 128, so embedding tables
    tile cleanly on matrix units)."""

    BOS = 256
    EOS = 257
    PAD = 258
    IM_START = 259   # chat-turn delimiters (ChatML-style)
    IM_END = 260

    _SPECIAL = {BOS: "<s>", EOS: "</s>", PAD: "<pad>", IM_START: "<|im_start|>", IM_END: "<|im_end|>"}

    def __init__(self):
        self.eos_token_id = self.EOS
        self.bos_token_id = self.BOS
        self.pad_token_id = self.PAD
        self.vocab_size = 512

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        out = bytearray()
        parts: List[str] = []
        for i in ids:
            if i < 256:
                out.append(i)
            elif i in self._SPECIAL:
                if not skip_special_tokens:
                    if out:
                        parts.append(out.decode("utf-8", errors="replace"))
                        out = bytearray()
                    parts.append(self._SPECIAL[i])
            else:
                # out-of-vocab id (e.g. random-init model with a larger lm
                # head than the byte vocab): emit a visible placeholder
                # instead of silently dropping — smoke tests stream
                # *something*. Must not be U+FFFD: DecodeStream holds back
                # trailing U+FFFD as a split-multibyte sentinel.
                if out:
                    parts.append(out.decode("utf-8", errors="replace"))
                    out = bytearray()
                parts.append(f"<unk:{i}>")
        if out:
            parts.append(out.decode("utf-8", errors="replace"))
        return "".join(parts)

    def apply_chat_template(
        self, messages: List[Dict[str, Any]], add_generation_prompt: bool = True
    ) -> str:
        parts = []
        for m in messages:
            content = m.get("content") or ""
            if isinstance(content, list):
                content = "".join(
                    p.get("text", "") for p in content if p.get("type") == "text"
                )
            parts.append(f"<|im_start|>{m['role']}\n{content}<|im_end|>\n")
        if add_generation_prompt:
            parts.append("<|im_start|>assistant\n")
        return "".join(parts)

    def encode_chat(self, messages: List[Dict[str, Any]]) -> List[int]:
        """Template-aware encoding: delimiters become real special ids so the
        model (and stop handling) can see turn boundaries."""
        ids: List[int] = [self.BOS]
        for m in messages:
            content = m.get("content") or ""
            if isinstance(content, list):
                content = "".join(
                    p.get("text", "") for p in content if p.get("type") == "text"
                )
            ids.append(self.IM_START)
            ids.extend(self.encode(f"{m['role']}\n{content}"))
            ids.append(self.IM_END)
        ids.append(self.IM_START)
        ids.extend(self.encode("assistant\n"))
        return ids


class HFTokenizer:
    """transformers.AutoTokenizer adapter (local paths only, offline)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer  # deferred: a heavy, optional import

        self._tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.eos_token_id = self._tok.eos_token_id
        self.bos_token_id = self._tok.bos_token_id
        self.vocab_size = len(self._tok)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        return self._tok.decode(ids, skip_special_tokens=skip_special_tokens)

    def apply_chat_template(
        self, messages: List[Dict[str, Any]], add_generation_prompt: bool = True
    ) -> str:
        return self._tok.apply_chat_template(
            messages, tokenize=False, add_generation_prompt=add_generation_prompt
        )

    def encode_chat(self, messages: List[Dict[str, Any]]) -> List[int]:
        return self._tok.apply_chat_template(messages, tokenize=True,
                                             add_generation_prompt=True)


def load_tokenizer(ref: Optional[str]) -> Tokenizer:
    """None or "byte" -> ByteTokenizer; a local path -> HFTokenizer; any
    other reference falls back to the byte tokenizer with a warning, as the
    reference does."""
    if ref is None or ref == "byte":
        return ByteTokenizer()
    if os.path.exists(ref):
        return HFTokenizer(ref)
    log.warning("tokenizer ref %r not found locally; falling back to byte tokenizer", ref)
    return ByteTokenizer()


class DecodeStream:
    """Incremental detokenization: feed token ids, get printable text deltas.

    Holds back text while the current suffix could still be an incomplete
    UTF-8 sequence (decode yields U+FFFD at the boundary)."""

    def __init__(self, tokenizer: Tokenizer, skip_special_tokens: bool = True):
        self._tok = tokenizer
        self._ids: List[int] = []
        self._emitted = 0  # chars already released
        self._skip_special = skip_special_tokens

    def step(self, token_ids: Iterable[int]) -> str:
        self._ids.extend(token_ids)
        text = self._tok.decode(self._ids, skip_special_tokens=self._skip_special)
        # hold back a trailing replacement char: likely a split multibyte seq
        safe_end = len(text)
        while safe_end > self._emitted and text[safe_end - 1] == "�":
            safe_end -= 1
        delta = text[self._emitted : safe_end]
        self._emitted = safe_end
        return delta

    def flush(self) -> str:
        text = self._tok.decode(self._ids, skip_special_tokens=self._skip_special)
        delta = text[self._emitted :]
        self._emitted = len(text)
        return delta
