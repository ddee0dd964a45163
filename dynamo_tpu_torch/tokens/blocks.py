"""Chained block hashing over token id sequences.

Hash design: ``seq_hash[i] = H(seq_hash[i-1] || tokens[i])`` with a 64-bit
stable digest (blake2b/8), optionally salted by an "extra key" (lora id,
multimodal content hash) the way the reference mixes extra state into its
``PositionalSequenceHash`` (lib/tokens/src/blocks.rs:59). Stability across
processes and hosts matters: routers and workers must agree on hashes.
"""

from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Iterable, List, Optional, Sequence

BlockHash = int      # hash of one block's tokens alone
SequenceHash = int   # chained hash: identifies block *in its prefix context*

_U64 = struct.Struct("<Q")


def _digest64(payload: bytes) -> int:
    return _U64.unpack(hashlib.blake2b(payload, digest_size=8).digest())[0]


def compute_block_hash(tokens: Sequence[int], extra_key: Optional[bytes] = None) -> BlockHash:
    payload = b"".join(_U64.pack(t & 0xFFFFFFFFFFFFFFFF) for t in tokens)
    if extra_key:
        payload += b"\x00" + extra_key
    return _digest64(payload)


def chain_hash(parent: Optional[SequenceHash], block_hash: BlockHash) -> SequenceHash:
    if parent is None:
        return _digest64(b"root" + _U64.pack(block_hash))
    return _digest64(_U64.pack(parent) + _U64.pack(block_hash))


def compute_sequence_hashes(
    tokens: Sequence[int],
    block_size: int,
    extra_key: Optional[bytes] = None,
) -> List[SequenceHash]:
    """Sequence hashes for every *complete* block of ``tokens``."""
    out: List[SequenceHash] = []
    parent: Optional[SequenceHash] = None
    for start in range(0, len(tokens) - len(tokens) % block_size, block_size):
        bh = compute_block_hash(tokens[start : start + block_size], extra_key)
        parent = chain_hash(parent, bh)
        out.append(parent)
    return out


@dataclasses.dataclass(frozen=True)
class TokenBlock:
    tokens: tuple
    block_hash: BlockHash
    sequence_hash: SequenceHash
    parent_hash: Optional[SequenceHash]
    position: int  # block index within the sequence


class TokenBlockSequence:
    """A token id sequence chunked into hashed blocks + a mutable partial tail.

    Supports incremental append (decode loop grows the sequence one token at a
    time and new blocks seal as they fill), mirroring the reference's
    TokenBlockSequence (lib/tokens/src/lib.rs).
    """

    def __init__(
        self,
        tokens: Iterable[int] = (),
        block_size: int = 16,
        extra_key: Optional[bytes] = None,
    ):
        if block_size <= 0:
            raise ValueError(f"block_size must be positive, got {block_size}")
        self.block_size = block_size
        self.extra_key = extra_key
        self.blocks: List[TokenBlock] = []
        self._tail: List[int] = []
        self.extend(tokens)

    # -- growth -------------------------------------------------------------
    def append(self, token: int) -> Optional[TokenBlock]:
        """Add one token; returns the newly sealed block if one completed."""
        self._tail.append(token)
        if len(self._tail) == self.block_size:
            return self._seal()
        return None

    def extend(self, tokens: Iterable[int]) -> List[TokenBlock]:
        sealed = []
        for t in tokens:
            b = self.append(t)
            if b is not None:
                sealed.append(b)
        return sealed

    def _seal(self) -> TokenBlock:
        parent = self.blocks[-1].sequence_hash if self.blocks else None
        bh = compute_block_hash(self._tail, self.extra_key)
        sh = chain_hash(parent, bh)
        block = TokenBlock(
            tokens=tuple(self._tail),
            block_hash=bh,
            sequence_hash=sh,
            parent_hash=parent,
            position=len(self.blocks),
        )
        self.blocks.append(block)
        self._tail = []
        return block

    # -- views --------------------------------------------------------------
    @property
    def tail_tokens(self) -> List[int]:
        return list(self._tail)

    def sequence_hashes(self) -> List[SequenceHash]:
        return [b.sequence_hash for b in self.blocks]

    def tokens(self) -> List[int]:
        out: List[int] = []
        for b in self.blocks:
            out.extend(b.tokens)
        out.extend(self._tail)
        return out

    def __len__(self) -> int:
        return len(self.blocks) * self.block_size + len(self._tail)

    def num_blocks(self) -> int:
        return len(self.blocks)
