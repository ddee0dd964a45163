"""The port's image input (dynamo_tpu_torch/llm/media.py on its own PNG and
JPEG decoders and Pillow's bilinear resize, llm/image_codecs.py) held to
the reference's ``dynamo_tpu.llm.media.decode_image`` (PIL) on a corpus
that PIL writes here, seeded:

- PNG: every colour type at every bit depth, Adam7 interlace, palettes with
  tRNS, 16-bit samples, odd sizes; every filter type (PIL's encoder picks
  them per row; the corpus is checked to hold all five). Exact.
- JPEG: quality 50 and 95, 4:4:4 / 4:2:2 / 4:2:0, grey, restart markers,
  odd sizes, the Adobe transform (RGB kept) and RGB component ids. The
  port mirrors libjpeg's integer paths; the tolerance reached is 0 levels
  (exact), and the test holds it there.
- Each decoded at 28 and 224 pixels (down- and upsampling).
- Refused formats: a 400 naming the format and ROADMAP.
- A chat request with image parts gives the reference preprocessor's
  tokens and ``images`` annotation; the worker's ``tiny-vl`` card carries
  the reference's image fields.
"""

import base64
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dynamo_tpu.llm import media as jmedia
from dynamo_tpu_torch.llm import image_codecs as codecs
from dynamo_tpu_torch.llm import media as tmedia
from dynamo_tpu_torch.runtime.errors import InvalidRequestError

SIZES = (28, 224)
# the tolerance this port reaches on JPEG, in levels of 255 at any pixel
JPEG_TOLERANCE = 0


def _picture(h, w, c, seed):
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    base = (np.sin(7 * x + 3 * y * (1 + np.arange(c))) * 0.5 + 0.5) * 190
    return (base + rng.integers(0, 65, (h, w, c))).astype(np.uint8)


def _save(im, fmt, **kw) -> bytes:
    b = io.BytesIO()
    im.save(b, fmt, **kw)
    return b.getvalue()


def _png_corpus():
    out = {}
    for k, (h, w) in enumerate([(37, 53), (9, 1), (1, 12), (64, 40)]):
        rgba = Image.fromarray(_picture(h, w, 4, k), "RGBA")
        for mode in ("RGB", "RGBA", "L", "LA", "1", "P"):
            for inter in (0, 1):
                out[f"{mode}-{h}x{w}-i{inter}"] = _save(rgba.convert(mode), "PNG",
                                                        interlace=inter)
        rng = np.random.default_rng(10 + k)
        for hi in (65535, 300):
            g16 = Image.fromarray(rng.integers(0, hi, (h, w)).astype(np.uint16))
            out[f"I16-max{hi}-{h}x{w}"] = _save(g16, "PNG")
        rgb16 = (rng.integers(0, 65535, (h, w, 3)).astype(">u2"))
        out[f"RGB16-{h}x{w}"] = _png_bytes(rgb16, 2, 16)
        out[f"RGBA16-{h}x{w}"] = _png_bytes(
            rng.integers(0, 65535, (h, w, 4)).astype(">u2"), 6, 16, interlace=1)
        out[f"LA16-{h}x{w}"] = _png_bytes(rng.integers(0, 65535, (h, w, 2)).astype(">u2"), 4, 16)
        for bits in (1, 2, 4):
            n = 1 << bits
            idx = rng.integers(0, n, (h, w)).astype(np.uint8)
            im = Image.fromarray(idx, "P")
            im.putpalette(rng.integers(0, 256, 3 * n).tolist())
            out[f"P{bits}-trns-{h}x{w}"] = _save(im, "PNG", bits=bits, transparency=0)
            grey = Image.fromarray((idx * (255 // (n - 1))).astype(np.uint8), "L")
            out[f"L{bits}-{h}x{w}"] = _save(grey, "PNG", bits=bits)
            out[f"L{bits}-i-{h}x{w}"] = _save(grey, "PNG", bits=bits, interlace=1)
        # a short palette (indices past its end read as black) with tRNS
        small = Image.fromarray(rng.integers(0, 200, (h, w)).astype(np.uint8), "P")
        small.putpalette(rng.integers(0, 256, 30).tolist())
        out[f"P8-short-{h}x{w}"] = _save(small, "PNG", transparency=bytes([0, 128, 255]))
    return out


def _png_bytes(samples, color_type, depth, interlace=0) -> bytes:
    """A PNG written here (PIL cannot save 16-bit colour): every row's
    filter cycles through the five types."""
    h, w = samples.shape[:2]
    raw = samples.tobytes()
    bpp = samples.shape[2] * depth // 8

    def filtered(rows, stride):
        out, prev = bytearray(), bytes(stride)
        for y, row in enumerate(rows):
            ft = y % 5
            line = bytearray(stride)
            for i in range(stride):
                a = row[i - bpp] if i >= bpp else 0
                b = prev[i]
                c = prev[i - bpp] if i >= bpp else 0
                if ft == 0:
                    pred = 0
                elif ft == 1:
                    pred = a
                elif ft == 2:
                    pred = b
                elif ft == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                line[i] = (row[i] - pred) & 0xFF
            out += bytes([ft]) + line
            prev = row
        return bytes(out)

    stride = w * bpp
    full = [raw[y * stride:(y + 1) * stride] for y in range(h)]
    if not interlace:
        data = filtered(full, stride)
    else:
        data = b""
        arr = np.frombuffer(raw, np.uint8).reshape(h, w, bpp)
        for x0, y0, dx, dy in codecs._ADAM7:
            sub = arr[y0::dy, x0::dx]
            if sub.size:
                data += filtered([r.tobytes() for r in sub], sub.shape[1] * bpp)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, interlace)
    return (codecs.PNG_SIGNATURE + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(data))
            + chunk(b"IEND", b""))


def _with_component_ids(jpeg: bytes, ids: bytes, drop_app0: bool) -> bytes:
    """Rewrite a JPEG's component ids in its frame and scan headers (and
    drop its JFIF marker): libjpeg then reads the colour space from the
    ids."""
    out, pos = bytearray(jpeg[:2]), 2
    while pos < len(jpeg):
        marker = jpeg[pos + 1]
        n = struct.unpack(">H", jpeg[pos + 2:pos + 4])[0]
        seg = bytearray(jpeg[pos:pos + 2 + n])
        if marker == 0xC0:
            for k in range(3):
                seg[10 + 3 * k] = ids[k]
        if marker == 0xDA:
            for k in range(seg[4]):
                seg[5 + 2 * k] = ids[k]
            out += seg + jpeg[pos + 2 + n:]
            return bytes(out)
        if not (marker == 0xE0 and drop_app0):
            out += seg
        pos += 2 + n
    raise AssertionError("no scan")


def _jpeg_corpus():
    out = {}
    for k, (h, w) in enumerate([(37, 53), (64, 64), (17, 9), (3, 2), (120, 95)]):
        rgb = Image.fromarray(_picture(h, w, 3, 20 + k))
        for q in (50, 95):
            for ss in (0, 1, 2):
                out[f"q{q}-ss{ss}-{h}x{w}"] = _save(rgb, "JPEG", quality=q, subsampling=ss)
            out[f"grey-q{q}-{h}x{w}"] = _save(rgb.convert("L"), "JPEG", quality=q)
        out[f"restart-{h}x{w}"] = _save(rgb, "JPEG", quality=80, subsampling=2,
                                        restart_marker_blocks=3)
        out[f"restart-rows-{h}x{w}"] = _save(rgb, "JPEG", quality=80, subsampling=1,
                                             restart_marker_rows=1)
        out[f"adobe-rgb-{h}x{w}"] = _save(rgb, "JPEG", quality=90, keep_rgb=True)
        plain = _save(rgb, "JPEG", quality=85, subsampling=0)
        out[f"ids-RGB-{h}x{w}"] = _with_component_ids(plain, b"RGB", drop_app0=True)
        out[f"ids-other-{h}x{w}"] = _with_component_ids(plain, b"\x05\x06\x07", drop_app0=True)
    return out


PNGS = _png_corpus()
JPEGS = _jpeg_corpus()


def _url(raw: bytes, mime: str) -> str:
    return f"data:{mime};base64,{base64.b64encode(raw).decode()}"


def test_the_png_corpus_holds_every_filter_type():
    seen = set()
    for raw in PNGS.values():
        samples, header = codecs.decode_png_samples(raw)
        data = zlib.decompress(b"".join(d for k, d in codecs._png_chunks(raw) if k == b"IDAT"))
        if not header["interlace"]:
            ch = codecs._PNG_CHANNELS[header["color_type"]]
            stride = (header["width"] * ch * header["depth"] + 7) // 8
            seen |= {data[y * (stride + 1)] for y in range(header["height"])}
    assert seen == {0, 1, 2, 3, 4}


@pytest.mark.parametrize("name", sorted(PNGS))
def test_png_decodes_exactly_as_the_reference(name):
    raw = PNGS[name]
    want_rgb = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
    np.testing.assert_array_equal(codecs.decode_rgb(raw), want_rgb)
    for size in SIZES:
        got = tmedia.decode_image(_url(raw, "image/png"), size)
        want = jmedia.decode_image(_url(raw, "image/png"), size)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(JPEGS))
def test_jpeg_decodes_as_the_reference_within_the_tolerance(name):
    raw = JPEGS[name]
    want_rgb = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB")).astype(int)
    got_rgb = codecs.decode_rgb(raw).astype(int)
    assert np.abs(got_rgb - want_rgb).max() <= JPEG_TOLERANCE
    for size in SIZES:
        got = tmedia.decode_image(_url(raw, "image/jpeg"), size)
        want = jmedia.decode_image(_url(raw, "image/jpeg"), size)
        assert got.shape == want.shape == (size, size, 3)
        assert np.abs(got - want).max() * 255 <= JPEG_TOLERANCE + 1e-3


@pytest.mark.parametrize("shape", [(37, 53), (300, 200), (224, 224), (10, 700), (5, 5)])
def test_the_resize_is_pillows_bilinear_bit_for_bit(shape):
    img = _picture(*shape, 3, 7)
    for size in SIZES + (13, 401):
        want = np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR))
        np.testing.assert_array_equal(codecs.resize_bilinear(img, size, size), want)
    want = np.asarray(Image.fromarray(img).resize((31, 17), Image.BILINEAR))
    np.testing.assert_array_equal(codecs.resize_bilinear(img, 31, 17), want)


def _refused():
    rgb = Image.fromarray(_picture(20, 24, 3, 3))
    out = {
        "progressive": (_save(rgb, "JPEG", progressive=True), "progressive JPEG"),
        "cmyk": (_save(rgb.convert("CMYK"), "JPEG"), "CMYK JPEG"),
        "gif": (_save(rgb, "GIF"), "GIF"),
        "bmp": (_save(rgb, "BMP"), "BMP"),
        "tiff": (_save(rgb, "TIFF"), "TIFF"),
        "webp": (_save(rgb, "WEBP"), "WebP"),
        # SOF9: an arithmetic-coded frame header
        "arithmetic": (_save(rgb, "JPEG").replace(b"\xff\xc0", b"\xff\xc9", 1),
                       "arithmetic-coded JPEG"),
        "garbage": (b"not an image at all", "cannot identify image file"),
        "truncated-png": (PNGS["RGB-37x53-i0"][:-30], "PNG"),
        "bad-crc": (PNGS["RGB-37x53-i0"][:40] + b"\x00" + PNGS["RGB-37x53-i0"][41:], "CRC"),
    }
    return out


REFUSED = _refused()


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_formats_are_a_400_naming_the_format(name):
    raw, words = REFUSED[name]
    with pytest.raises(InvalidRequestError, match=words) as e:
        tmedia.decode_image(_url(raw, "image/x"), 28)
    assert e.value.http_status == 400
    if name not in ("truncated-png", "bad-crc"):
        assert "ROADMAP" in str(e.value)


def test_urls_npy_and_file_roots_as_the_reference(tmp_path, monkeypatch):
    arr = _picture(12, 9, 3, 5)
    buf = io.BytesIO()
    np.save(buf, arr)
    npy = f"data:application/x-npy;base64,{base64.b64encode(buf.getvalue()).decode()}"
    for size in SIZES:
        np.testing.assert_array_equal(tmedia.decode_image(npy, size),
                                      jmedia.decode_image(npy, size))
    (tmp_path / "a.png").write_bytes(PNGS["RGB-64x40-i0"])
    np.save(tmp_path / "b.npy", arr.astype(np.float32) / 255.0)
    outside = tmp_path.parent / "outside.png"
    outside.write_bytes(PNGS["RGB-64x40-i0"])
    cases = [f"file://{tmp_path}/a.png", f"file://{tmp_path}/b.npy", f"file://{outside}",
             "https://example.invalid/x.png", "ftp://x"]

    def outcome(fn, url):
        try:
            return "ok", fn(url, 28)
        except ValueError as e:
            return "error", str(e)

    for root in (None, str(tmp_path)):
        if root is None:
            monkeypatch.delenv("DTPU_MEDIA_FILE_ROOT", raising=False)
        else:
            monkeypatch.setenv("DTPU_MEDIA_FILE_ROOT", root)
        for url in cases:
            got, want = outcome(tmedia.decode_image, url), outcome(jmedia.decode_image, url)
            assert got[0] == want[0], url
            if got[0] == "ok":
                np.testing.assert_array_equal(got[1], want[1])
            else:
                assert got[1] == want[1]
    os.remove(outside)


def _chat(parts):
    return {"model": "m", "max_tokens": 4,
            "messages": [{"role": "system", "content": "look"},
                         {"role": "user", "content": parts}]}


@pytest.mark.parametrize("parts", [
    [{"type": "text", "text": "what is this?"},
     {"type": "image_url", "image_url": {"url": _url(PNGS["RGBA-37x53-i1"], "image/png")}}],
    [{"type": "image_url", "image_url": {"url": _url(JPEGS["q95-ss2-37x53"], "image/jpeg")}},
     {"type": "image_url", "image_url": {"url": _url(PNGS["P4-trns-64x40"], "image/png")}},
     {"type": "text", "text": "compare"}],
])
def test_a_chat_request_with_images_preprocesses_as_the_reference(parts):
    from dynamo_tpu.llm import model_card as jcard
    from dynamo_tpu.llm import preprocessor as jpre
    from dynamo_tpu.llm.protocols import openai as jopenai
    from dynamo_tpu.llm.tokenizer import ByteTokenizer as JByte
    from dynamo_tpu_torch.llm import model_card as tcard
    from dynamo_tpu_torch.llm import preprocessor as tpre
    from dynamo_tpu_torch.llm.protocols import openai as topenai
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    body = _chat(parts)
    kw = dict(name="m", tokenizer="byte", context_length=4096, image_tokens=4, image_size=28)
    want = jpre.OpenAIPreprocessor(jcard.ModelDeploymentCard(**kw), JByte()).preprocess_chat(
        jopenai.ChatCompletionRequest.model_validate(body))
    got = tpre.OpenAIPreprocessor(tcard.ModelDeploymentCard(**kw), ByteTokenizer()).preprocess_chat(
        topenai.ChatCompletionRequest.from_obj(body))
    w, g = want.to_obj(), got.to_obj()
    w.pop("request_id"), g.pop("request_id")
    assert g == w
    n_images = sum(p["type"] == "image_url" for p in parts)
    assert len(g["annotations"]["images"]) == n_images
    assert g["token_ids"].count(tcard.ModelDeploymentCard(**kw).image_token_id) == 4 * n_images


def test_the_tiny_vl_workers_card_carries_the_references_image_fields():
    from dynamo_tpu.engine import __main__ as jworker
    from dynamo_tpu.engine.engine import TpuEngineConfig
    from dynamo_tpu.models.llama import LlamaConfig
    from dynamo_tpu_torch.engine import __main__ as tworker

    args = tworker.parse_args(["--preset", "tiny-vl", "--device", "cpu", "--model", "vl",
                               "--max-context", "256", "--num-blocks", "64"])
    engine, tok_ref = tworker.build_worker_engine(args)
    try:
        card = tworker.worker_card(args, engine, tok_ref, None, None)
    finally:
        engine.stop()
    vcfg = jworker.VISION_PRESETS["tiny-vl"](LlamaConfig())
    assert (card.image_tokens, card.image_size, card.image_token_id) == (
        vcfg.num_patches, vcfg.image_size, TpuEngineConfig.image_token_id) == (4, 28, 0x7FFFF0)
    plain = tworker.parse_args(["--preset", "tiny", "--device", "cpu", "--max-context", "256",
                                "--num-blocks", "64"])
    engine, tok_ref = tworker.build_worker_engine(plain)
    try:
        assert tworker.worker_card(plain, engine, tok_ref, None, None).image_tokens == 0
    finally:
        engine.stop()


def _png_bytes(w, h, idat: bytes, depth=8, ctype=2) -> bytes:
    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (codecs.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


def _jpeg_with_size(w, h) -> bytes:
    raw = _save(Image.fromarray(_picture(16, 16, 3, 2)), "JPEG")
    sof = raw.index(b"\xff\xc0")
    return raw[:sof + 5] + struct.pack(">HH", h, w) + raw[sof + 9:]


@pytest.mark.parametrize("fmt", ["png", "jpeg"])
def test_a_header_past_pils_pixel_limit_is_a_400_before_any_allocation(fmt):
    """PIL refuses more than 2 x MAX_IMAGE_PIXELS pixels as a decompression
    bomb; the port refuses the same header with PIL's words, as a 400,
    before it allocates anything of that size."""
    import tracemalloc

    from PIL.Image import DecompressionBombError

    w, h = 20000, 9000
    raw = (_png_bytes(w, h, zlib.compress(b"\x00" * 64)) if fmt == "png"
           else _jpeg_with_size(w, h))
    with pytest.raises(DecompressionBombError) as ref:
        jmedia.decode_image(_url(raw, "image/x"), 28)
    tracemalloc.start()
    try:
        with pytest.raises(InvalidRequestError) as e:
            tmedia.decode_image(_url(raw, "image/x"), 28)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert e.value.http_status == 400
    assert str(e.value) == str(ref.value)
    assert peak < 1 << 20
    assert codecs.MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS


def test_a_zlib_bomb_inflates_no_further_than_the_image():
    """An IDAT stream that inflates to 64 MiB for a 32 x 16 image: PIL stops
    once the image is complete, and so does the port, without inflating
    the rest."""
    import tracemalloc

    rows = np.zeros((16, 1 + 32 * 3), np.uint8)
    rows[:, 1:] = _picture(16, 32, 3, 7).reshape(16, -1)
    idat = zlib.compress(rows.tobytes() + bytes(64 << 20), 9)
    raw = _png_bytes(32, 16, idat)
    assert len(raw) < 1 << 20
    tracemalloc.start()
    try:
        got = tmedia.decode_image(_url(raw, "image/png"), 28)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    np.testing.assert_array_equal(got, jmedia.decode_image(_url(raw, "image/png"), 28))
    assert peak < 4 << 20


def test_images_at_users_sizes_decode_as_the_reference(monkeypatch):
    """A 1024 x 768 PNG with every filter type on a fifth of its rows each
    (the encoder phase 8 of chip_smoke.py times on the card's host), and
    1024 x 768 JPEGs from PIL (4:2:0, quality 90) and from that encoder:
    exact to PIL, full size and at 224 px; and again with the PNG
    wavefront cut into strips of 64 rows and the IDCT into calls of 100
    blocks, as a larger image is."""
    import chip_smoke

    img = chip_smoke.synth_image(1024, 768, seed=3)
    cases = {"synth png": chip_smoke.synth_png(img), "synth jpeg": chip_smoke.synth_jpeg(img),
             "pil jpeg": _save(Image.fromarray(img), "JPEG", quality=90)}
    for name, raw in cases.items():
        want = np.asarray(Image.open(io.BytesIO(raw)).convert("RGB"))
        np.testing.assert_array_equal(codecs.decode_rgb(raw), want, err_msg=name)
        url = _url(raw, "image/x")
        np.testing.assert_array_equal(tmedia.decode_image(url, 224),
                                      jmedia.decode_image(url, 224), err_msg=name)
    np.testing.assert_array_equal(codecs.decode_rgb(cases["synth png"]), img)
    monkeypatch.setattr(codecs, "_WAVEFRONT_BYTES", 64 * (64 + 1024) * 3)
    monkeypatch.setattr(codecs, "_IDCT_BLOCKS", 100)
    np.testing.assert_array_equal(codecs.decode_rgb(cases["synth png"]), img)
    np.testing.assert_array_equal(codecs.decode_rgb(cases["pil jpeg"]),
                                  np.asarray(Image.open(io.BytesIO(cases["pil jpeg"]))))


def test_a_chat_request_with_images_decodes_off_the_event_loop(monkeypatch):
    """The HTTP service preprocesses through ``apreprocess_chat``: a request
    with images is decoded on the image thread while the loop goes on; one
    without images is preprocessed inline. Both equal ``preprocess_chat``."""
    import asyncio
    import threading

    from dynamo_tpu_torch.llm import model_card as tcard
    from dynamo_tpu_torch.llm import preprocessor as tpre
    from dynamo_tpu_torch.llm.protocols import openai as topenai
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    card = tcard.ModelDeploymentCard(name="m", tokenizer="byte", context_length=4096,
                                     image_tokens=4, image_size=28)
    pre = tpre.OpenAIPreprocessor(card, ByteTokenizer())
    threads, real = [], tmedia.decode_image

    def spy(url, size):
        threads.append(threading.current_thread())
        return real(url, size)

    monkeypatch.setattr(tmedia, "decode_image", spy)
    with_image = topenai.ChatCompletionRequest.from_obj(_chat([
        {"type": "text", "text": "what is this?"},
        {"type": "image_url", "image_url": {"url": _url(JPEGS["q95-ss2-37x53"],
                                                        "image/jpeg")}}]))
    text_only = topenai.ChatCompletionRequest.from_obj(_chat("hello"))

    async def main():
        loop_thread = threading.current_thread()
        ticks = 0

        async def ticker():
            nonlocal ticks
            while True:
                ticks += 1
                await asyncio.sleep(0)

        t = asyncio.ensure_future(ticker())
        got = await pre.apreprocess_chat(with_image)
        t.cancel()
        plain = await pre.apreprocess_chat(text_only)
        return loop_thread, ticks, got, plain

    loop_thread, ticks, got, plain = asyncio.run(main())
    assert len(threads) == 1 and threads[0] is not loop_thread
    assert threads[0].name.startswith("image-decode") and ticks > 0
    for a, b in ((got, pre.preprocess_chat(with_image)), (plain, pre.preprocess_chat(text_only))):
        a, b = a.to_obj(), b.to_obj()
        a.pop("request_id"), b.pop("request_id")
        assert a == b
