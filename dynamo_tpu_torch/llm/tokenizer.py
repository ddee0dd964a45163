"""Byte-level tokenizer and incremental detokenization.

Copies of ``ByteTokenizer`` and ``DecodeStream`` from the reference
package's llm/tokenizer.py: UTF-8 bytes as tokens (ids 256+ are special
tokens), exact text round trip, no assets. The HF tokenizer wrapper comes
with the slice that loads real checkpoints.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Sequence


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


class DecodeStream:
    """Incremental detokenization: feed token ids, get printable text deltas.

    Holds back text while the current suffix could still be an incomplete
    UTF-8 sequence (decode yields U+FFFD at the boundary)."""

    def __init__(self, tokenizer: ByteTokenizer, skip_special_tokens: bool = True):
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
