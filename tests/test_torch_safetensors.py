"""The port's safetensors reader (engine/safetensors_io.py: torch, json and
mmap) against the safetensors package's own loaders, ``safetensors.numpy.
load_file`` (bf16 through ``ml_dtypes``) and ``safetensors.torch.
load_file``: every dtype it takes, two shards, a 0-d tensor, an empty
tensor and ``__metadata__``; and headers it must refuse.
"""

import json
import os
import struct
import warnings

import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load
from safetensors.numpy import save_file
from safetensors.torch import load_file as torch_load

from dynamo_tpu_torch.engine import safetensors_io as sio

NP = {"F64": np.float64, "F32": np.float32, "F16": np.float16, "BF16": ml_dtypes.bfloat16,
      "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8, "U8": np.uint8,
      "BOOL": np.bool_}


def _arrays(seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, dt in NP.items():
        if name == "BOOL":
            out[f"t.{name}"] = rng.random((3, 5)) > 0.5
        elif np.dtype(dt).kind in "iu":
            info = np.iinfo(dt)
            out[f"t.{name}"] = rng.integers(info.min, info.max, size=(4, 3, 2), dtype=dt,
                                            endpoint=True)
        else:
            out[f"t.{name}"] = (rng.standard_normal((7, 3)) * 100).astype(dt)
    out["scalar"] = np.array(2.5, np.float32)
    out["empty"] = np.zeros((0, 4), ml_dtypes.bfloat16)
    out["odd.i8"] = rng.integers(-128, 127, size=(5,), dtype=np.int8)   # unaligned after it
    return out


def _same(got: torch.Tensor, want) -> None:
    want_t = want if isinstance(want, torch.Tensor) else None
    if want_t is None:
        want_t = (torch.from_numpy(want.view(np.uint16)).view(torch.bfloat16)
                  if want.dtype == ml_dtypes.bfloat16 else torch.from_numpy(np.array(want)))
    assert got.dtype == want_t.dtype and got.shape == want_t.shape
    assert got.is_contiguous()
    if got.numel():
        assert torch.equal(got.reshape(-1).view(torch.uint8), want_t.reshape(-1).view(torch.uint8))


@pytest.fixture
def shards(tmp_path):
    a, b = _arrays(0), {f"b.{k}": v for k, v in _arrays(1).items()}
    save_file(a, str(tmp_path / "model-00001-of-00002.safetensors"), metadata={"format": "pt"})
    save_file(b, str(tmp_path / "model-00002-of-00002.safetensors"))
    (tmp_path / "config.json").write_text("{}")
    return tmp_path


def test_every_dtype_equals_the_package_loaders(shards):
    with warnings.catch_warnings():
        warnings.simplefilter("error")   # no read-only buffer warning
        got = list(sio.read_safetensors(str(shards), "cpu"))
    names = [n for n, _ in got]
    want_np, want_t = {}, {}
    for f in sorted(os.listdir(shards)):
        if f.endswith(".safetensors"):
            want_np.update(np_load(str(shards / f)))
            want_t.update(torch_load(str(shards / f)))
    assert sorted(names) == sorted(want_np) and len(names) == 2 * len(_arrays(0))
    # shard order, then name order within a shard (the reference's order)
    assert names == sorted(n for n in names if not n.startswith("b.")) + sorted(
        n for n in names if n.startswith("b."))
    for name, t in got:
        _same(t, want_np[name])
        _same(t, want_t[name])
    by_name = dict(got)
    assert by_name["scalar"].shape == () and float(by_name["scalar"]) == 2.5
    assert by_name["empty"].shape == (0, 4) and by_name["empty"].dtype == torch.bfloat16
    assert set(sio.DTYPES) == set(NP)


def test_tensors_own_their_memory(shards):
    """Each tensor is a copy: none refers to the mapped file."""
    got = dict(sio.read_safetensors(str(shards), "cpu"))
    t = got["t.F32"]
    before = t.clone()
    t.add_(1)
    again = dict(sio.read_safetensors(str(shards), "cpu"))
    assert torch.equal(again["t.F32"], before)


def _shard(tmp_path, header: dict, data: bytes, name="x.safetensors", pad=True):
    blob = json.dumps(header).encode()
    if pad:
        blob += b" " * (-len(blob) % 8)
    d = tmp_path / "ck"
    d.mkdir(exist_ok=True)
    (d / name).write_bytes(struct.pack("<Q", len(blob)) + blob + data)
    return str(d)


@pytest.mark.parametrize("case", [
    "truncated data", "offsets disagree with shape", "unknown dtype", "header past the file",
    "short file", "reversed offsets", "not an object", "missing keys"])
def test_bad_headers_raise(tmp_path, case):
    t = {"dtype": "F32", "shape": [2, 2], "data_offsets": [0, 16]}
    header, data = {"w": t}, bytes(16)
    if case == "truncated data":
        data = bytes(12)
    elif case == "offsets disagree with shape":
        header = {"w": dict(t, shape=[3, 2])}
    elif case == "unknown dtype":
        header = {"w": dict(t, dtype="F8_E4M3")}
    elif case == "reversed offsets":
        header = {"w": dict(t, data_offsets=[16, 0])}
    elif case == "not an object":
        header = [1, 2]
    elif case == "missing keys":
        header = {"w": {"dtype": "F32", "shape": [2, 2]}}
    path = _shard(tmp_path, header, data)
    if case == "header past the file":
        f = os.path.join(path, "x.safetensors")
        raw = open(f, "rb").read()
        open(f, "wb").write(struct.pack("<Q", 10 ** 6) + raw[8:])
    elif case == "short file":
        open(os.path.join(path, "x.safetensors"), "wb").write(b"\x01\x00\x00")
    with pytest.raises(ValueError):
        list(sio.read_safetensors(path, "cpu"))


def test_metadata_is_skipped_and_files_are_sorted(tmp_path):
    header = {"__metadata__": {"format": "pt"},
              "w": {"dtype": "I32", "shape": [2], "data_offsets": [0, 8]}}
    _shard(tmp_path, header, struct.pack("<ii", 7, -3), name="b.safetensors")
    path = _shard(tmp_path, {"v": {"dtype": "U8", "shape": [1], "data_offsets": [0, 1]}},
                  b"\x09", name="a.safetensors")
    (tmp_path / "ck" / "notes.txt").write_text("not a shard")
    got = list(sio.read_safetensors(path, "cpu"))
    assert [n for n, _ in got] == ["v", "w"]
    assert got[1][1].tolist() == [7, -3] and got[0][1].tolist() == [9]
