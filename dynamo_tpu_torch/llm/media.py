"""Media decoding for multimodal requests.

The port's copy of the reference package's llm/media.py: ``data:`` URLs
(base64 image bytes, or raw ``.npy`` payloads) and local ``file://`` paths
under ``DTPU_MEDIA_FILE_ROOT``; remote http(s) fetch is refused (the
serving tier has no egress). Image bytes go through the port's own PNG and
JPEG decoders and Pillow's bilinear resize (llm/image_codecs.py), which
give the reference's PIL path its bytes; other formats are a 400.
"""

from __future__ import annotations

import base64
import io
import os
import urllib.parse

import numpy as np

from ..runtime.logging import get_logger
from .image_codecs import decode_rgb, resize_bilinear

log = get_logger("llm.media")


def decode_image(url: str, image_size: int) -> np.ndarray:
    """URL -> float32 RGB array [image_size, image_size, 3] in [0, 1]."""
    if url.startswith("data:"):
        header, _, b64 = url.partition(",")
        raw = base64.b64decode(b64)
        if "application/x-npy" in header:
            arr = np.load(io.BytesIO(raw), allow_pickle=False)
            return _normalize(arr, image_size)
        return _decode_bytes(raw, image_size)
    if url.startswith("file://"):
        # arbitrary local reads driven by client URLs are a file-disclosure
        # hole: file:// only works under an operator-allowlisted root
        root = os.environ.get("DTPU_MEDIA_FILE_ROOT")
        if not root:
            raise ValueError(
                "file:// image urls are disabled (set DTPU_MEDIA_FILE_ROOT "
                "to an allowed directory to enable)"
            )
        path = os.path.realpath(urllib.parse.urlparse(url).path)
        if not path.startswith(os.path.realpath(root) + os.sep):
            raise ValueError("image path outside DTPU_MEDIA_FILE_ROOT")
        if path.endswith(".npy"):
            return _normalize(np.load(path, allow_pickle=False), image_size)
        with open(path, "rb") as f:
            return _decode_bytes(f.read(), image_size)
    raise ValueError(
        f"unsupported image url scheme {url[:32]!r} (data: and file:// only)"
    )


def _decode_bytes(raw: bytes, image_size: int) -> np.ndarray:
    img = decode_rgb(raw)
    if img.shape[:2] != (image_size, image_size):
        img = resize_bilinear(img, image_size, image_size)
    return np.asarray(img, np.float32) / 255.0


def _normalize(arr: np.ndarray, image_size: int) -> np.ndarray:
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected [H, W, 3] image array, got {arr.shape}")
    if arr.max() > 1.5:
        arr = arr / 255.0
    if arr.shape[:2] != (image_size, image_size):
        # nearest-neighbor resize for arrays, as the reference's
        ys = (np.arange(image_size) * arr.shape[0] / image_size).astype(int)
        xs = (np.arange(image_size) * arr.shape[1] / image_size).astype(int)
        arr = arr[ys][:, xs]
    return np.ascontiguousarray(arr, np.float32)
