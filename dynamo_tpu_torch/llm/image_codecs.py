"""PNG and baseline JPEG decoders and Pillow's bilinear resize, on numpy.

The reference package decodes image bytes with PIL
(``Image.open(raw).convert("RGB").resize((s, s), Image.BILINEAR)``); the
machine the port serves on has no PIL, so this module reproduces those
three steps with ``zlib``, ``struct`` and numpy, to the same bytes:

- PNG: every colour type (0, 2, 3, 4, 6) at every bit depth it allows,
  the five filters, Adam7 interlace, PLTE and tRNS, chunk CRCs. The
  conversion to RGB follows PIL's ``convert("RGB")`` mode by mode, quirks
  included: alpha is dropped (not composited over a background), 16-bit
  samples keep their high byte, and 16-bit grey goes through PIL's ``I;16``
  mode, whose conversion clips at 255 instead of scaling.
- JPEG: 8-bit sequential Huffman (SOF0 and SOF1), 1 or 3 components, any
  sampling factors (4:4:4, 4:2:2 and 4:2:0 through libjpeg's fancy
  upsamplers), restart markers, interleaved and single-component scans,
  the JFIF and Adobe colour transforms. Pillow decodes through libjpeg with
  the ``islow`` integer IDCT (jidctint.c), fancy upsampling (jdsample.c)
  and fixed-point YCbCr -> RGB (jdcolor.c, 16 scale bits); the same integer
  paths are mirrored here.
- ``resize_bilinear``: Pillow's separable resampler (Resample.c), the
  triangle filter with its support scaled by the factor when downsampling,
  coefficients in 22-bit fixed point, rounding and clipping to uint8 after
  each pass (horizontal, then vertical).

Progressive and arithmetic-coded JPEG, CMYK / YCCK JPEG, 12-bit JPEG, GIF,
WebP, BMP and TIFF are refused with ``UnsupportedImageError`` (a 400 naming
ROADMAP Queue 1): the port decodes nothing approximately.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..runtime.errors import InvalidRequestError

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class UnsupportedImageError(InvalidRequestError):
    """An image the port's decoders refuse, or bytes that are not a valid
    image."""


def _refuse(fmt: str) -> UnsupportedImageError:
    return UnsupportedImageError(
        f"{fmt} images are not decoded by this server yet (ROADMAP Queue 1: the "
        f"port decodes PNG and baseline JPEG)")


# PIL's Image.MAX_IMAGE_PIXELS: Image.open refuses an image of more than
# twice as many pixels as a decompression bomb
MAX_IMAGE_PIXELS = int(1024 * 1024 * 1024 // 4 // 3)


def check_pixels(width: int, height: int) -> None:
    """PIL's decompression-bomb check on a header's size, before anything
    of that size is allocated."""
    pixels = max(1, width) * max(1, height)
    if pixels > 2 * MAX_IMAGE_PIXELS:
        raise UnsupportedImageError(
            f"Image size ({pixels} pixels) exceeds limit of {2 * MAX_IMAGE_PIXELS} "
            "pixels, could be decompression bomb DOS attack.")


def sniff(raw: bytes) -> str:
    """The container format of ``raw``: png, jpeg, gif, webp, bmp, tiff or
    unknown."""
    if raw.startswith(PNG_SIGNATURE):
        return "png"
    if raw.startswith(b"\xff\xd8"):
        return "jpeg"
    if raw[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    if raw[:4] == b"RIFF" and raw[8:12] == b"WEBP":
        return "webp"
    if raw[:2] == b"BM":
        return "bmp"
    if raw[:4] in (b"II*\x00", b"MM\x00*"):
        return "tiff"
    return "unknown"


def decode_rgb(raw: bytes) -> np.ndarray:
    """Image bytes -> uint8 [H, W, 3], as PIL's ``convert("RGB")`` gives."""
    fmt = sniff(raw)
    if fmt == "png":
        return decode_png(raw)
    if fmt == "jpeg":
        return decode_jpeg(raw)
    if fmt == "unknown":
        raise UnsupportedImageError("cannot identify image file (ROADMAP Queue 1: the port "
                                    "decodes PNG and baseline JPEG)")
    raise _refuse(fmt.upper() if fmt != "webp" else "WebP")


# ---------------------------------------------------------------------------
# PNG

# Adam7 passes: (x start, y start, x step, y step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunks(raw: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(raw):
        (n,) = struct.unpack(">I", raw[pos:pos + 4])
        kind = raw[pos + 4:pos + 8]
        data = raw[pos + 8:pos + 8 + n]
        if len(data) != n or pos + 12 + n > len(raw):
            raise UnsupportedImageError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", raw[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + data) & 0xFFFFFFFF != crc:
            raise UnsupportedImageError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, data
        pos += 12 + n
        if kind == b"IEND":
            return
    raise UnsupportedImageError("PNG without IEND")


# the most bytes each of the PNG wavefront's two skewed copies may take
_WAVEFRONT_BYTES = 1 << 27


def _skewed(base: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """A writable view ``v[r, j] = base[r + j, r]`` of a [diagonal, row,
    byte] array: pixel (r, j) of a [rows, cols, bpp] image on its
    anti-diagonal r + j."""
    sd, sr, sb = base.strides
    return np.lib.stride_tricks.as_strided(
        base, shape=(rows, cols, base.shape[2]), strides=(sd + sr, sd, sb))


def _unfilter(data: memoryview, start: int, rows: int, stride: int, bpp: int
              ) -> Tuple[np.ndarray, int]:
    """Reverse the per-row filters of ``rows`` scanlines of ``stride`` bytes
    starting at ``start``; returns (uint8 [rows, stride], end offset).

    A byte depends on its left, upper and upper-left neighbours (one pixel,
    ``bpp`` bytes, to the left), so all pixels of one anti-diagonal are
    independent: the rows are skewed onto their diagonals and each
    diagonal is one vector step, whatever filter each row uses."""
    end = start + rows * (1 + stride)
    if end > len(data):
        raise UnsupportedImageError("truncated PNG image data")
    lines = np.frombuffer(data, np.uint8, rows * (1 + stride), start).reshape(rows, 1 + stride)
    ftypes = lines[:, 0]
    if int(ftypes.max()) > 4:
        raise UnsupportedImageError(f"bad PNG filter type {int(ftypes.max())}")
    cols = -(-stride // bpp)
    raw = np.zeros((rows, cols * bpp), np.uint8)
    raw[:, :stride] = lines[:, 1:]
    raw = raw.reshape(rows, cols, bpp)
    if int(ftypes.max()) <= 2:
        # no filter reads its left result but Sub, a running sum along each
        # byte lane: one vector step a row
        out = np.empty_like(raw)
        prev = np.zeros((cols, bpp), np.uint8)
        for y in range(rows):
            f = ftypes[y]
            if f == 1:
                out[y] = np.cumsum(raw[y], axis=0, dtype=np.uint8)
            elif f == 2:
                np.add(raw[y], prev, out=out[y])
            else:
                out[y] = raw[y]
            prev = out[y]
        return out.reshape(rows, -1)[:, :stride], end
    # strips of rows, so that the skewed copies ([strip + cols] x strip x
    # bpp each) stay within _WAVEFRONT_BYTES; each strip reads the last row
    # of the one above
    strip = rows
    while strip > 64 and (strip + cols) * strip * bpp > _WAVEFRONT_BYTES:
        strip //= 2
    ft = ftypes.astype(np.int16)[:, None]
    out = np.empty_like(raw)
    above = np.zeros((cols, bpp), np.uint8)
    for y0 in range(0, rows, strip):
        n = min(strip, rows - y0)
        ndiag = n + cols - 1
        src = np.zeros((ndiag, n, bpp), np.uint8)
        _skewed(src, n, cols)[...] = raw[y0:y0 + n]
        # res[d + 2, r + 1] holds pixel (r, d - r); row 0 holds the row
        # above the strip (pixel (-1, j) at res[j + 1, 0]), and zeros stand
        # for what the filters read past the image's top and left edges
        res = np.zeros((ndiag + 2, n + 1, bpp), np.uint8)
        res[1:cols + 1, 0] = above
        sub, up, avg, paeth = ((ft[y0:y0 + n] == k) for k in (1, 2, 3, 4))
        for d in range(ndiag):
            r0, r1 = max(0, d - cols + 1), min(n, d + 1)
            a = res[d + 1, r0 + 1:r1 + 1].astype(np.int16)    # left
            b = res[d + 1, r0:r1].astype(np.int16)            # up
            c = res[d, r0:r1].astype(np.int16)                # up-left
            bc, ac = b - c, a - c
            pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = np.where(paeth[r0:r1], pred, np.where(avg[r0:r1], (a + b) >> 1,
                                                         a * sub[r0:r1] + b * up[r0:r1]))
            res[d + 2, r0 + 1:r1 + 1] = src[d, r0:r1] + pred.astype(np.uint8)
        out[y0:y0 + n] = _skewed(res[2:, 1:], n, cols)
        above = out[y0 + n - 1]
    return out.reshape(rows, -1)[:, :stride], end


def _unpack_samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Filtered-away scanlines [h, stride] -> samples [h, width, channels]
    (uint8, or uint16 at depth 16)."""
    h = rows.shape[0]
    if depth == 16:
        s = rows.reshape(h, -1).view(">u2").astype(np.uint16)
        return s[:, :width * channels].reshape(h, width, channels)
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)
    per = 8 // depth
    n = rows.shape[1] * per
    bits = bits.reshape(h, n, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(axis=2, dtype=np.uint8)
    return vals[:, :width].reshape(h, width, 1)


def decode_png_samples(raw: bytes) -> Tuple[np.ndarray, dict]:
    """PNG bytes -> (samples [H, W, channels], header); samples are the
    file's own values (uint16 at depth 16), palette indices for colour
    type 3."""
    header: dict = {}
    idat = []
    for kind, data in _png_chunks(raw):
        if kind == b"IHDR":
            if len(data) != 13:
                raise UnsupportedImageError("bad PNG IHDR")
            w, h, depth, ctype, comp, filt, inter = struct.unpack(">IIBBBBB", data)
            if ctype not in _PNG_DEPTHS or depth not in _PNG_DEPTHS[ctype]:
                raise UnsupportedImageError(f"bad PNG colour type {ctype} / depth {depth}")
            if comp != 0 or filt != 0 or inter not in (0, 1) or not w or not h:
                raise UnsupportedImageError("bad PNG header")
            check_pixels(w, h)
            header.update(width=w, height=h, depth=depth, color_type=ctype, interlace=inter)
        elif kind == b"PLTE":
            if len(data) % 3:
                raise UnsupportedImageError("bad PNG palette")
            header["palette"] = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            header["trns"] = bytes(data)
        elif kind == b"IDAT":
            idat.append(data)
    if "width" not in header or not idat:
        raise UnsupportedImageError("PNG without IHDR or IDAT")
    w, h, depth = header["width"], header["height"], header["depth"]
    ch = _PNG_CHANNELS[header["color_type"]]
    bpp = max(1, depth * ch // 8)
    dtype = np.uint16 if depth == 16 else np.uint8
    passes = [(0, 0, 1, 1, w, h)] if not header["interlace"] else [
        (x0, y0, dx, dy, (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy)
        for x0, y0, dx, dy in _ADAM7]
    passes = [p for p in passes if p[4] > 0 and p[5] > 0]
    expected = sum(ph * (1 + (pw * ch * depth + 7) // 8) for *_, pw, ph in passes)
    try:
        # inflate no further than the scanlines the header announces (as
        # PIL's decoder stops once the image is complete): a small zlib
        # stream cannot expand past the image
        data = memoryview(zlib.decompressobj().decompress(b"".join(idat), expected))
    except zlib.error as e:
        raise UnsupportedImageError(f"corrupt PNG image data: {e}") from None
    samples = np.zeros((h, w, ch), dtype)
    pos = 0
    for x0, y0, dx, dy, pw, ph in passes:
        stride = (pw * ch * depth + 7) // 8
        rows, pos = _unfilter(data, pos, ph, stride, bpp)
        samples[y0::dy, x0::dx] = _unpack_samples(rows, pw, depth, ch)
    return samples, header


def _png_rgb(samples: np.ndarray, header: dict) -> np.ndarray:
    """Samples -> uint8 RGB as PIL's ``convert("RGB")`` of PIL's mode for
    the file."""
    ctype, depth = header["color_type"], header["depth"]
    if ctype == 3:
        pal = header.get("palette")
        if pal is None:
            raise UnsupportedImageError("PNG palette image without PLTE")
        # PIL's palette has 256 entries; entries the file leaves out read
        # as black
        full = np.zeros((256, 3), np.uint8)
        full[:len(pal)] = pal[:256]
        return full[samples[..., 0]]
    if depth == 16:
        if ctype == 0:
            # PIL opens it as I;16, whose conversion clips at 255
            grey = np.minimum(samples[..., 0], 255).astype(np.uint8)
        else:
            # the RGB;16B / LA;16B / RGBA;16B unpackers keep the high byte
            grey = None
            samples = (samples >> 8).astype(np.uint8)
    elif ctype == 0:
        # L;1 is mode "1" (0 / 255); L;2 and L;4 scale to 0..255
        grey = (samples[..., 0] * (255 // ((1 << depth) - 1))).astype(np.uint8)
    else:
        grey = None
    if ctype == 0:
        return np.repeat(grey[..., None], 3, axis=2)
    if ctype == 4:              # LA: alpha dropped
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])   # RGB, RGBA: alpha dropped


def decode_png(raw: bytes) -> np.ndarray:
    samples, header = decode_png_samples(raw)
    return np.ascontiguousarray(_png_rgb(samples, header))


# ---------------------------------------------------------------------------
# baseline JPEG

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_REFUSED_SOF = {
    0xC2: "progressive JPEG", 0xC3: "lossless JPEG", 0xC5: "hierarchical JPEG",
    0xC6: "hierarchical progressive JPEG", 0xC7: "hierarchical lossless JPEG",
    0xC9: "arithmetic-coded JPEG", 0xCA: "arithmetic-coded progressive JPEG",
    0xCB: "arithmetic-coded lossless JPEG", 0xCD: "arithmetic-coded JPEG",
    0xCE: "arithmetic-coded JPEG", 0xCF: "arithmetic-coded JPEG",
}


class _Huffman:
    """A canonical Huffman table read through a 16-bit lookahead ``peek``.

    ``dc[peek]`` is ``(code length, size)``. ``ac[peek]`` is ``(bits,
    run, value, size)``: where the code and its ``size`` extra bits fit in
    the lookahead, ``bits`` covers both and ``value`` is the coefficient
    (``size`` 0); otherwise ``bits`` is the code's length and ``size`` extra
    bits follow. An end of block has run -1, a run of 16 zeros is run 15
    with value 0, and a code that is no code has 0 bits."""

    _cache: Dict[bytes, "_Huffman"] = {}

    @classmethod
    def get(cls, counts: List[int], symbols: bytes) -> "_Huffman":
        """The table for these counts and symbols, built once (most files
        carry the same few tables)."""
        key = bytes(counts) + symbols
        tab = cls._cache.get(key)
        if tab is None:
            if len(cls._cache) >= 64:
                cls._cache.clear()
            tab = cls._cache[key] = cls(counts, symbols)
        return tab

    def __init__(self, counts: List[int], symbols: bytes):
        lut = np.zeros(1 << 16, np.int64)
        code, k = 0, 0
        for length in range(1, 17):
            for _ in range(counts[length - 1]):
                if k >= len(symbols):
                    raise UnsupportedImageError("bad JPEG Huffman table")
                lo = code << (16 - length)
                hi = (code + 1) << (16 - length)
                if hi > (1 << 16):
                    raise UnsupportedImageError("bad JPEG Huffman table")
                lut[lo:hi] = (symbols[k] << 8) | length
                code += 1
                k += 1
            code <<= 1
        self.lut = lut
        self._dc: Optional[list] = None
        self._ac: Optional[list] = None

    @property
    def dc(self) -> list:
        if self._dc is None:
            size = self.lut >> 8
            # a DC difference has at most 16 bits: a larger size is no code
            length = np.where(size > 16, 0, self.lut & 0xFF)
            self._dc = list(zip(length.tolist(), size.tolist()))
        return self._dc

    @property
    def ac(self) -> list:
        if self._ac is None:
            peek = np.arange(1 << 16, dtype=np.int64)
            length, rs = self.lut & 0xFF, self.lut >> 8
            run, size = rs >> 4, rs & 15
            fits = (size > 0) & (length + size <= 16)
            extra = (peek >> np.maximum(16 - length - size, 0)) & ((1 << size) - 1)
            value = np.where(extra < (1 << np.maximum(size - 1, 0)),
                             extra - (1 << size) + 1, extra)
            bits = np.where(fits, length + size, length)
            value = np.where(fits, value, 0)
            eob = (size == 0) & (run != 15)
            run = np.where(eob, -1, run)
            size = np.where(fits, 0, size)
            self._ac = list(zip(bits.tolist(), run.tolist(), value.tolist(), size.tolist()))
        return self._ac


class _Component:
    def __init__(self, cid: int, h: int, v: int, tq: int):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coefs: Optional[np.ndarray] = None   # [rows of blocks, cols, 64 zigzag]


def _segments(raw: bytes, pos: int) -> Tuple[List[bytes], int]:
    """The entropy-coded data from ``pos``: byte stuffing removed, split at
    RST markers; returns (segments, offset of the marker ending the scan)."""
    segs, cur = [], bytearray()
    n = len(raw)
    while True:
        j = raw.find(b"\xff", pos)
        if j < 0 or j + 1 >= n:
            raise UnsupportedImageError("truncated JPEG scan")
        cur += raw[pos:j]
        nxt = raw[j + 1]
        if nxt == 0x00:
            cur.append(0xFF)
            pos = j + 2
        elif nxt == 0xFF:     # fill byte
            pos = j + 1
        elif 0xD0 <= nxt <= 0xD7:
            segs.append(bytes(cur))
            cur = bytearray()
            pos = j + 2
        else:
            segs.append(bytes(cur))
            return segs, j


# a block's codes and extra bits span at most 64 x (16 + 16) bits: zero
# bytes read past a segment's end before the block's truncation check
_SEG_PAD = 64 * 32 // 8 + 8


def _words(seg: bytes) -> memoryview:
    """The big-endian 32-bit word at every byte offset of a segment (zero
    bytes past its end): the 16-bit lookahead at bit ``p`` is ``(w[p >> 3]
    >> (16 - (p & 7))) & 0xFFFF``."""
    b = np.frombuffer(seg + bytes(_SEG_PAD + 3), np.uint8).astype(np.uint32)
    w = (b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]
    return memoryview(w)


def _decode_scan(raw: bytes, pos: int, scan: list, frame: dict, dc_tabs: dict,
                 ac_tabs: dict, restart: int) -> int:
    """Huffman-decode one sequential scan into each component's ``coefs``
    (zigzag order); returns the offset after the scan's data."""
    segs, end = _segments(raw, pos)
    comps = [c for c, _, _ in scan]
    interleaved = len(comps) > 1
    if interleaved:
        mcux, mcuy = frame["mcux"], frame["mcuy"]
    else:
        c = comps[0]
        mcux = -(-c.width // 8)
        mcuy = -(-c.height // 8)
    for c, td, ta in scan:
        if dc_tabs.get(td) is None or ac_tabs.get(ta) is None:
            raise UnsupportedImageError("JPEG scan names a missing Huffman table")
    # each unit of an MCU: (component slot, DC table, AC table, offset of its
    # block in the component's flat coefficients from the MCU's first block,
    # the MCU's step in x and in y there, where its positions and values go)
    found: List[Tuple[list, list]] = [([], []) for _ in comps]
    units = []
    for i, (c, td, ta) in enumerate(scan):
        cols = c.coefs.shape[1]
        bh, bv = (c.h, c.v) if interleaved else (1, 1)
        units += [(i, dc_tabs[td].dc, ac_tabs[ta].ac, (dy * cols + dx) * 64, bh * 64,
                   bv * cols * 64, found[i][0].append, found[i][1].append)
                  for dy in range(bv) for dx in range(bh)]
    total = mcux * mcuy
    per_seg = restart if restart else total
    seg_i = 0
    mcu = 0
    while mcu < total:
        if seg_i >= len(segs):
            raise UnsupportedImageError("truncated JPEG scan")
        w = _words(segs[seg_i])
        limit = 8 * len(segs[seg_i])
        seg_i += 1
        p = 0
        pred = [0] * len(comps)
        for m in range(mcu, min(total, mcu + per_seg)):
            my, mx = divmod(m, mcux)
            for i, dc, ac, off, sx, sy, at, vals in units:
                base = my * sy + mx * sx + off
                n, s = dc[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                if not n:
                    raise UnsupportedImageError("corrupt JPEG data (bad Huffman code)")
                p += n
                if s:
                    x = ((w[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                    pred[i] += x - (1 << s) + 1 if x < (1 << (s - 1)) else x
                    p += s
                at(base)
                vals(pred[i])
                k = 1
                while k < 64:
                    n, r, v, s = ac[(w[p >> 3] >> (16 - (p & 7))) & 0xFFFF]
                    if not n:
                        raise UnsupportedImageError("corrupt JPEG data (bad Huffman code)")
                    p += n
                    if r < 0:
                        break
                    k += r
                    if s:
                        x = ((w[p >> 3] << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
                        v = x - (1 << s) + 1 if x < (1 << (s - 1)) else x
                        p += s
                    if v:
                        if k > 63:
                            raise UnsupportedImageError("corrupt JPEG data (run past the block)")
                        at(base + k)
                        vals(v)
                    k += 1
                if p > limit:
                    raise UnsupportedImageError("truncated JPEG scan")
        mcu += per_seg
    for c, (at, vals) in zip(comps, found):
        flat = c.coefs.reshape(-1)
        flat[np.asarray(at, np.int64)] = np.asarray(vals, np.int64)
    return end


# jidctint.c constants (CONST_BITS 13, PASS1_BITS 2)
_F = {"0_298": 2446, "0_390": 3196, "0_541": 4433, "0_765": 6270, "0_899": 7373,
      "1_175": 9633, "1_501": 12299, "1_847": 15137, "1_961": 16069, "2_053": 16819,
      "2_562": 20995, "3_072": 25172}


def _idct_pass(x: List[np.ndarray], shift: int) -> List[np.ndarray]:
    """One 1-D pass of jpeg_idct_islow over 8 int64 lanes; the outputs are
    descaled by ``shift`` bits with rounding."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * _F["0_541"]
    tmp2 = z1 - z3 * _F["1_847"]
    tmp3 = z1 + z2 * _F["0_765"]
    tmp0 = (x[0] + x[4]) << 13
    tmp1 = (x[0] - x[4]) << 13
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F["1_175"]
    t0 = t0 * _F["0_298"]
    t1 = t1 * _F["2_053"]
    t2 = t2 * _F["3_072"]
    t3 = t3 * _F["1_501"]
    z1 = z1 * -_F["0_899"]
    z2 = z2 * -_F["2_562"]
    z3 = z3 * -_F["1_961"] + z5
    z4 = z4 * -_F["0_390"] + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    half = 1 << (shift - 1)
    return [(v + half) >> shift for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


# blocks per IDCT call: its int64 lanes take ~1 KiB a block
_IDCT_BLOCKS = 1 << 15

# libjpeg's post-IDCT range limit: index (value & 1023) -> sample
_RANGE = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                         np.arange(0, 128)]).astype(np.uint8)


def idct_islow(coefs: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer IDCT: coefficients [..., 64] (natural
    order) and a quantisation table [64] -> uint8 samples [..., 8, 8]."""
    d = coefs.astype(np.int64) * qtable.astype(np.int64)
    d = d.reshape(-1, 8, 8)            # [block, row, col]
    cols = _idct_pass([d[:, u, :] for u in range(8)], 13 - 2)   # per column
    ws = np.stack(cols, axis=1)        # [block, row, col]
    rows = _idct_pass([ws[:, :, u] for u in range(8)], 13 + 2 + 3)
    out = np.stack(rows, axis=2)       # [block, row, col]
    return _RANGE[out & 1023].reshape(coefs.shape[:-1] + (8, 8))


def _fancy_h2(x: np.ndarray, width: int) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample over rows of ``width`` (> 2) samples."""
    x = x.astype(np.int32)
    out = np.empty((x.shape[0], 2 * width), np.int32)
    cur = x * 3
    out[:, 0] = x[:, 0]
    out[:, 1] = (cur[:, 0] + x[:, 1] + 2) >> 2
    out[:, 2:2 * width - 2:2] = (cur[:, 1:width - 1] + x[:, 0:width - 2] + 1) >> 2
    out[:, 3:2 * width - 2:2] = (cur[:, 1:width - 1] + x[:, 2:width] + 2) >> 2
    out[:, 2 * width - 2] = (cur[:, width - 1] + x[:, width - 2] + 1) >> 2
    out[:, 2 * width - 1] = x[:, width - 1]
    return out


def _rows_with_context(x: np.ndarray, height: int) -> Tuple[np.ndarray, np.ndarray]:
    """Each of the first ``height`` rows' neighbour above and below, with
    the edge rows duplicated (jdmainct.c's context rows)."""
    rows = x[:height].astype(np.int32)
    above = np.concatenate([rows[:1], rows[:-1]], axis=0)
    below = np.concatenate([rows[1:], rows[-1:]], axis=0)
    return above, below


def _fancy_h2v2(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample (``width`` > 2)."""
    rows = x[:height].astype(np.int32)
    above, below = _rows_with_context(x, height)
    out = np.empty((2 * height, 2 * width), np.int32)
    for v, nb in ((0, above), (1, below)):
        cs = rows * 3 + nb
        o = out[v::2]
        o[:, 0] = (cs[:, 0] * 4 + 8) >> 4
        o[:, 1] = (cs[:, 0] * 3 + cs[:, 1] + 7) >> 4
        o[:, 2:2 * width - 2:2] = (cs[:, 1:width - 1] * 3 + cs[:, 0:width - 2] + 8) >> 4
        o[:, 3:2 * width - 2:2] = (cs[:, 1:width - 1] * 3 + cs[:, 2:width] + 7) >> 4
        o[:, 2 * width - 2] = (cs[:, width - 1] * 3 + cs[:, width - 2] + 8) >> 4
        o[:, 2 * width - 1] = (cs[:, width - 1] * 4 + 7) >> 4
    return out


def _fancy_v2(x: np.ndarray, width: int, height: int) -> np.ndarray:
    """jdsample.c h1v2_fancy_upsample."""
    rows = x[:height, :width].astype(np.int32)
    above, below = _rows_with_context(x[:, :width], height)
    out = np.empty((2 * height, width), np.int32)
    out[0::2] = (rows * 3 + above + 1) >> 2
    out[1::2] = (rows * 3 + below + 2) >> 2
    return out


def _upsample(plane: np.ndarray, c: _Component, hmax: int, vmax: int) -> np.ndarray:
    fh, fv = hmax // c.h, vmax // c.v
    w, h = c.width, c.height
    if fh == 1 and fv == 1:
        return plane
    # libjpeg takes the fancy 2h forms only above 2 samples a row
    if fh == 2 and fv == 1 and w > 2:
        return _fancy_h2(plane[:h], w)
    if fh == 2 and fv == 2 and w > 2:
        return _fancy_h2v2(plane, w, h)
    if fh == 1 and fv == 2:
        return _fancy_v2(plane, w, h)
    # libjpeg's generic integral upsampler replicates each sample
    return np.repeat(np.repeat(plane, fv, axis=0), fh, axis=1)


# jdcolor.c fixed-point YCbCr -> RGB (SCALEBITS 16)
def _fix(x: float) -> int:
    return int(x * (1 << 16) + 0.5)


_X = np.arange(256, dtype=np.int64) - 128
_HALF = 1 << 15
_CR_R = (_fix(1.40200) * _X + _HALF) >> 16
_CB_B = (_fix(1.77200) * _X + _HALF) >> 16
_CR_G = -_fix(0.71414) * _X
_CB_G = -_fix(0.34414) * _X + _HALF


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    y = y.astype(np.int32)
    out = np.empty(y.shape + (3,), np.uint8)
    for i, v in enumerate((y + _CR_R[cr], y + ((_CB_G[cb] + _CR_G[cr]) >> 16),
                           y + _CB_B[cb])):
        out[..., i] = np.clip(v, 0, 255)
    return out


def decode_jpeg(raw: bytes) -> np.ndarray:
    """Baseline JPEG bytes -> uint8 [H, W, 3] as Pillow (libjpeg) decodes
    them and ``convert("RGB")`` returns them."""
    qt: Dict[int, np.ndarray] = {}
    dc_tabs: Dict[int, _Huffman] = {}
    ac_tabs: Dict[int, _Huffman] = {}
    frame: Optional[dict] = None
    comps: List[_Component] = []
    restart = 0
    jfif = False
    adobe: Optional[int] = None
    pos = 2
    n = len(raw)
    while pos < n:
        if raw[pos] != 0xFF:
            raise UnsupportedImageError("corrupt JPEG marker stream")
        while pos < n and raw[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        marker = raw[pos]
        pos += 1
        if marker == 0xD9:        # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > n:
            raise UnsupportedImageError("truncated JPEG")
        (length,) = struct.unpack(">H", raw[pos:pos + 2])
        seg = raw[pos + 2:pos + length]
        if len(seg) != length - 2:
            raise UnsupportedImageError("truncated JPEG segment")
        pos += length
        if marker in _REFUSED_SOF:
            raise _refuse(_REFUSED_SOF[marker])
        if marker == 0xDB:        # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                if pq:
                    vals = np.frombuffer(seg[i + 1:i + 129], ">u2").astype(np.int64)
                    i += 129
                else:
                    vals = np.frombuffer(seg[i + 1:i + 65], np.uint8).astype(np.int64)
                    i += 65
                if len(vals) != 64:
                    raise UnsupportedImageError("bad JPEG quantisation table")
                table = np.zeros(64, np.int64)
                table[_ZIGZAG] = vals
                qt[tq] = table
        elif marker == 0xC4:      # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                total = sum(counts)
                syms = bytes(seg[i + 17:i + 17 + total])
                (ac_tabs if tc else dc_tabs)[th] = _Huffman.get(counts, syms)
                i += 17 + total
        elif marker in (0xC0, 0xC1):   # SOF0 baseline, SOF1 extended Huffman
            prec, h, w, nc = struct.unpack(">BHHB", seg[:6])
            if prec != 8:
                raise _refuse(f"{prec}-bit JPEG")
            if nc == 4:
                raise _refuse("CMYK JPEG")
            if nc not in (1, 3) or not w or not h:
                raise UnsupportedImageError(f"JPEG with {nc} components")
            check_pixels(w, h)
            comps = []
            for k in range(nc):
                cid, hv, tq = seg[6 + 3 * k:9 + 3 * k]
                comps.append(_Component(cid, hv >> 4, hv & 15, tq))
            hmax = max(c.h for c in comps)
            vmax = max(c.v for c in comps)
            mcux = -(-w // (8 * hmax))
            mcuy = -(-h // (8 * vmax))
            for c in comps:
                if hmax % c.h or vmax % c.v:
                    raise UnsupportedImageError("JPEG with non-integral sampling factors")
                c.width = -(-w * c.h // hmax)
                c.height = -(-h * c.v // vmax)
                c.coefs = np.zeros((mcuy * c.v, mcux * c.h, 64), np.int16)
            frame = dict(width=w, height=h, hmax=hmax, vmax=vmax, mcux=mcux, mcuy=mcuy)
        elif marker == 0xDD:      # DRI
            (restart,) = struct.unpack(">H", seg[:2])
        elif marker == 0xE0 and seg[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
            adobe = seg[11]
        elif marker == 0xDA:      # SOS
            if frame is None:
                raise UnsupportedImageError("JPEG scan before its frame")
            ns = seg[0]
            by_id = {c.id: c for c in comps}
            scan = []
            for k in range(ns):
                cid, t = seg[1 + 2 * k], seg[2 + 2 * k]
                if cid not in by_id:
                    raise UnsupportedImageError("JPEG scan names an unknown component")
                scan.append((by_id[cid], t >> 4, t & 15))
            pos = _decode_scan(raw, pos, scan, frame, dc_tabs, ac_tabs, restart)
    if frame is None:
        raise UnsupportedImageError("JPEG without a baseline frame")
    hmax, vmax = frame["hmax"], frame["vmax"]
    W, H = frame["width"], frame["height"]
    planes = []
    for c in comps:
        if c.tq not in qt:
            raise UnsupportedImageError("JPEG component names a missing quantisation table")
        by, bx = c.coefs.shape[:2]
        plane = np.empty((by * 8, bx * 8), np.uint8)
        step = max(1, _IDCT_BLOCKS // bx)                 # block rows at a time
        for r in range(0, by, step):
            natural = np.zeros_like(c.coefs[r:r + step])
            natural[..., _ZIGZAG] = c.coefs[r:r + step]   # zigzag -> natural order
            blocks = idct_islow(natural, qt[c.tq])        # [rows, bx, 8, 8]
            plane[r * 8:(r + len(blocks)) * 8] = blocks.transpose(0, 2, 1, 3).reshape(-1, bx * 8)
        planes.append(_upsample(plane, c, hmax, vmax)[:H, :W])
    if len(comps) == 1:
        return np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    if jfif:
        rgb_space = False
    elif adobe is not None:
        rgb_space = adobe == 0
    else:
        rgb_space = [c.id for c in comps] == [82, 71, 66]
    if rgb_space:
        return np.stack([p.astype(np.uint8) for p in planes], axis=-1)
    return ycc_to_rgb(*planes)


# ---------------------------------------------------------------------------
# Pillow's bilinear resize (Resample.c)

PRECISION_BITS = 32 - 8 - 2


def _bilinear_filter(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


def resample_weights(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray]:
    """One bilinear pass's taps (precompute_coeffs + normalize_coeffs_8bpc):
    (first input index [out_size], fixed-point coefficients [out_size,
    taps]), zero past each output's own window."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ss = 1.0 / filterscale
    taps = int(np.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    weights = np.zeros((out_size, taps), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [_bilinear_filter((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        first[xx] = xmin
        for x in range(xmax):
            v = k[x] / ww if ww != 0.0 else k[x]
            weights[xx, x] = (int(-0.5 + v * (1 << PRECISION_BITS)) if v < 0
                              else int(0.5 + v * (1 << PRECISION_BITS)))
    return first, weights


def _pass(img: np.ndarray, taps: Tuple[np.ndarray, np.ndarray], axis: int) -> np.ndarray:
    # the coefficients are non-negative and sum to about 2^22, so a sum of
    # uint8 samples times them stays below 2^31
    first, weights = taps
    n = img.shape[axis]
    shape = [1] * img.ndim
    shape[axis] = len(first)
    acc = np.full([len(first) if i == axis else d for i, d in enumerate(img.shape)],
                  1 << (PRECISION_BITS - 1), np.int32)
    for t in range(weights.shape[1]):
        # a tap past the input's end has a zero coefficient: read any sample
        idx = np.minimum(first + t, n - 1)
        acc += np.take(img, idx, axis=axis).astype(np.int32) * \
            weights[:, t].astype(np.int32).reshape(shape)
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W, C] -> uint8 [height, width, C], as Pillow's
    ``resize((width, height), Image.BILINEAR)``."""
    h, w = img.shape[:2]
    out = img
    if width != w:
        out = _pass(out, resample_weights(w, width), axis=1)
    if height != h:
        out = _pass(out, resample_weights(h, height), axis=0)
    return np.ascontiguousarray(out)
