"""HPACK (RFC 7541): the header compression of HTTP/2, standard library only.

The decoder takes everything a peer may send: indexed fields from the
static and the dynamic table, literals with and without indexing (and
never-indexed ones), dynamic table size updates, and Huffman-coded names
and values (grpcio Huffman-codes its header values). The encoder sends
every field as a literal without indexing and without Huffman coding,
which every decoder must accept, so it keeps no table of its own.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

Header = Tuple[str, str]


class HpackError(ValueError):
    """A header block that does not decode (a COMPRESSION_ERROR)."""


STATIC_TABLE: Tuple[Header, ...] = (
    (":authority", ""), (":method", "GET"), (":method", "POST"), (":path", "/"),
    (":path", "/index.html"), (":scheme", "http"), (":scheme", "https"),
    (":status", "200"), (":status", "204"), (":status", "206"), (":status", "304"),
    (":status", "400"), (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""), ("accept-ranges", ""),
    ("accept", ""), ("access-control-allow-origin", ""), ("age", ""), ("allow", ""),
    ("authorization", ""), ("cache-control", ""), ("content-disposition", ""),
    ("content-encoding", ""), ("content-language", ""), ("content-length", ""),
    ("content-location", ""), ("content-range", ""), ("content-type", ""),
    ("cookie", ""), ("date", ""), ("etag", ""), ("expect", ""), ("expires", ""),
    ("from", ""), ("host", ""), ("if-match", ""), ("if-modified-since", ""),
    ("if-none-match", ""), ("if-range", ""), ("if-unmodified-since", ""),
    ("last-modified", ""), ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""), ("transfer-encoding", ""),
    ("user-agent", ""), ("vary", ""), ("via", ""), ("www-authenticate", ""),
)

# RFC 7541 Appendix B is a canonical Huffman code: codes are assigned in
# order of (length, symbol), so the code lengths of the 257 symbols (256 =
# EOS) define it. One letter per symbol, "A" = 5 bits.
_LENGTHS = (
    "ISXXXXXXXTZXXZXXXXXXXXZXXXXXXXXXBFFHIBDGFFDGDBBBAAABBBBBBBCDKBHFIB"
    "CCCCCCCCCCCCCCCCCCCCCCDCDIOIJBKABABABBBACCBBBABCBAABCCCCCKGJIXPRPP"
    "RRRSRSSSSSTSTTRSTSSSSQRSRSSTRQPRRSSQSRRTQRSSQQRQSRSSPRRRSRRSVVPORS"
    "RUVVVWWVTUOQVWWVWTQQVVXWWWPTPQRQQSRRUUTTVSVWVVWWWWWXWWWWWVZ")
EOS = 256


def _canonical() -> Tuple[List[int], List[int]]:
    lengths = [ord(c) - ord("A") + 5 for c in _LENGTHS]
    codes = [0] * len(lengths)
    code, prev = 0, 0
    for sym in sorted(range(len(lengths)), key=lambda s: (lengths[s], s)):
        code <<= lengths[sym] - prev
        prev = lengths[sym]
        codes[sym] = code
        code += 1
    return codes, lengths


HUFFMAN_CODES, HUFFMAN_LENGTHS = _canonical()
_DECODE: Dict[Tuple[int, int], int] = {
    (n, c): s for s, (c, n) in enumerate(zip(HUFFMAN_CODES, HUFFMAN_LENGTHS))}


def huffman_decode(data: bytes) -> bytes:
    out = bytearray()
    code, n = 0, 0
    for byte in data:
        for shift in range(7, -1, -1):
            code = (code << 1) | ((byte >> shift) & 1)
            n += 1
            sym = _DECODE.get((n, code))
            if sym is not None:
                if sym == EOS:
                    raise HpackError("EOS in a Huffman-coded string")
                out.append(sym)
                code, n = 0, 0
            elif n > 30:
                raise HpackError("bad Huffman code")
    # the padding: fewer than 8 bits, all ones
    if n > 7 or code != (1 << n) - 1:
        raise HpackError("bad Huffman padding")
    return bytes(out)


def _int(data: bytes, pos: int, prefix: int) -> Tuple[int, int]:
    mask = (1 << prefix) - 1
    if pos >= len(data):
        raise HpackError("truncated integer")
    value = data[pos] & mask
    pos += 1
    if value < mask:
        return value, pos
    shift = 0
    while True:
        if pos >= len(data) or shift > 28:
            raise HpackError("bad integer")
        b = data[pos]
        pos += 1
        value += (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def encode_int(value: int, prefix: int, first: int = 0) -> bytes:
    mask = (1 << prefix) - 1
    if value < mask:
        return bytes([first | value])
    out = bytearray([first | mask])
    value -= mask
    while value >= 128:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def _string(data: bytes, pos: int) -> Tuple[str, int]:
    if pos >= len(data):
        raise HpackError("truncated string")
    huff = data[pos] & 0x80
    n, pos = _int(data, pos, 7)
    raw = data[pos:pos + n]
    if len(raw) != n:
        raise HpackError("truncated string")
    if huff:
        raw = huffman_decode(raw)
    return raw.decode("latin-1"), pos + n


class Decoder:
    """One connection's header-block decoder and its dynamic table."""

    def __init__(self, max_table_size: int = 4096):
        self.max_allowed = max_table_size   # what this side advertised
        self.max_size = max_table_size
        self.size = 0
        self.table: List[Header] = []       # newest first

    def _add(self, name: str, value: str) -> None:
        self.table.insert(0, (name, value))
        self.size += len(name) + len(value) + 32
        self._evict()

    def _evict(self) -> None:
        while self.size > self.max_size and self.table:
            n, v = self.table.pop()
            self.size -= len(n) + len(v) + 32

    def _lookup(self, index: int) -> Header:
        if index <= 0:
            raise HpackError("header index 0")
        if index <= len(STATIC_TABLE):
            return STATIC_TABLE[index - 1]
        i = index - len(STATIC_TABLE) - 1
        if i >= len(self.table):
            raise HpackError(f"header index {index} past the dynamic table")
        return self.table[i]

    def decode(self, data: bytes) -> List[Header]:
        headers: List[Header] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:                        # indexed field
                index, pos = _int(data, pos, 7)
                headers.append(self._lookup(index))
                continue
            if b & 0xE0 == 0x20:                # dynamic table size update
                size, pos = _int(data, pos, 5)
                if size > self.max_allowed:
                    raise HpackError("table size update above the limit")
                self.max_size = size
                self._evict()
                continue
            indexing = b & 0xC0 == 0x40
            index, pos = _int(data, pos, 6 if indexing else 4)
            if index:
                name = self._lookup(index)[0]
            else:
                name, pos = _string(data, pos)
            value, pos = _string(data, pos)
            headers.append((name, value))
            if indexing:
                self._add(name, value)
        return headers


def encode(headers: List[Header]) -> bytes:
    """A header block of literals without indexing (names and values as
    plain octets)."""
    out = bytearray()
    for name, value in headers:
        n, v = name.encode("latin-1"), value.encode("latin-1")
        out += b"\x00" + encode_int(len(n), 7) + n + encode_int(len(v), 7) + v
    return bytes(out)
