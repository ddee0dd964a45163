"""The protobuf wire format of protos/kserve.proto, standard library only.

The port's counterpart of the reference's ``kserve_pb2.py`` (generated by
protoc, run on google.protobuf, which the machine the port serves on
lacks). Each message class below declares its fields; ``Message`` gives
them the generated classes' Python surface that the KServe service uses
(attribute access, ``repeated.add()`` / ``append`` / ``extend``, message
maps whose missing keys are created on access, ``WhichOneof``,
``SerializeToString`` / ``FromString``, ``==``) and the wire format:

- varint, zigzag, fixed32 / fixed64 and length-delimited fields;
- proto3 presence: a scalar outside a oneof is written only when it is not
  its default, a oneof member whenever it is set, a submessage when set;
- repeated numeric fields packed (either form is read);
- ``map<string, InferParameter>`` as repeated key / value entries;
- unknown fields skipped by wire type.

Fields are written in field-number order, as python protobuf writes them,
so a message without maps serializes to the same bytes.
"""

from __future__ import annotations

import struct
from typing import Dict, Optional, Tuple


class DecodeError(ValueError):
    """Bytes that are not a valid encoding of the message."""


VARINT, FIXED64, LENGTH, FIXED32 = 0, 1, 2, 5
_WIRE = {"bool": VARINT, "int32": VARINT, "int64": VARINT, "uint32": VARINT,
         "uint64": VARINT, "sint32": VARINT, "sint64": VARINT, "float": FIXED32,
         "double": FIXED64, "string": LENGTH, "bytes": LENGTH}
_DEFAULTS = {"bool": False, "float": 0.0, "double": 0.0, "string": "", "bytes": b""}


def encode_varint(value: int) -> bytes:
    value &= (1 << 64) - 1        # negatives as their 64-bit two's complement
    out = bytearray()
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def decode_varint(data: bytes, pos: int) -> Tuple[int, int]:
    value, shift = 0, 0
    while True:
        if pos >= len(data) or shift > 63:
            raise DecodeError("truncated or overlong varint")
        b = data[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            return value, pos


def zigzag_encode(value: int) -> int:
    return (value << 1) ^ (value >> 63)


def zigzag_decode(value: int) -> int:
    return (value >> 1) ^ -(value & 1)


def _scalar_bytes(kind: str, value) -> bytes:
    if kind == "float":
        return struct.pack("<f", value)
    if kind == "double":
        return struct.pack("<d", value)
    if kind in ("sint32", "sint64"):
        return encode_varint(zigzag_encode(int(value)))
    if kind == "bool":
        return b"\x01" if value else b"\x00"
    return encode_varint(int(value))


def _from_varint(kind: str, v: int):
    if kind == "bool":
        return bool(v)
    if kind in ("sint32", "sint64"):
        return zigzag_decode(v)
    if kind == "int64":
        return v - (1 << 64) if v >= 1 << 63 else v
    if kind == "int32":
        v &= 0xFFFFFFFF
        return v - (1 << 32) if v >= 1 << 31 else v
    if kind == "uint32":
        return v & 0xFFFFFFFF
    return v


def _len_prefixed(body: bytes) -> bytes:
    return encode_varint(len(body)) + body


def _skip(data: bytes, pos: int, wire: int) -> int:
    if wire == VARINT:
        return decode_varint(data, pos)[1]
    if wire == FIXED64:
        return pos + 8
    if wire == FIXED32:
        return pos + 4
    if wire == LENGTH:
        n, pos = decode_varint(data, pos)
        return pos + n
    raise DecodeError(f"unsupported wire type {wire}")


class Field:
    """One declared field: ``kind`` is a scalar type name, a Message class
    (a submessage) or ("map", value Message class)."""

    def __init__(self, number: int, name: str, kind, repeated: bool = False,
                 oneof: Optional[str] = None):
        self.number, self.name, self.kind = number, name, kind
        self.repeated, self.oneof = repeated, oneof
        self.is_map = isinstance(kind, tuple)
        self.is_message = isinstance(kind, type)


class RepeatedComposite(list):
    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def add(self, **kwargs) -> "Message":
        msg = self._cls(**kwargs)
        self.append(msg)
        return msg


class MessageMap(dict):
    """``map<string, Message>``: a missing key reads as a new message,
    stored (python protobuf's message-map behaviour)."""

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def __missing__(self, key):
        value = self[key] = self._cls()
        return value


class Message:
    FIELDS: Tuple[Field, ...] = ()

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_oneofs", {})
        # submessages created by a read: present once non-empty, as python
        # protobuf's are present once a field of theirs is set
        object.__setattr__(self, "_lazy", set())
        for f in self.FIELDS:
            if f.is_map:
                self._values[f.name] = MessageMap(f.kind[1])
            elif f.repeated:
                self._values[f.name] = RepeatedComposite(f.kind) if f.is_message else []
        for k, v in kwargs.items():
            f = self._field(k)
            if f.repeated or f.is_map:
                target = self._values[k]
                if f.is_map:
                    target.update(v)
                else:
                    target.extend(v)
            else:
                setattr(self, k, v)

    @classmethod
    def _field(cls, name: str) -> Field:
        for f in cls.FIELDS:
            if f.name == name:
                return f
        raise AttributeError(f"{cls.__name__} has no field {name!r}")

    def __getattr__(self, name: str):
        f = self._field(name)
        values = self._values
        if name in values:
            return values[name]
        if f.is_message:
            sub = values[name] = f.kind()
            self._lazy.add(name)
            return sub
        return _DEFAULTS.get(f.kind, 0)

    def __setattr__(self, name: str, value) -> None:
        f = self._field(name)
        if f.repeated or f.is_map:
            raise AttributeError(f"assignment to repeated field {name!r}")
        if f.oneof:
            prev = self._oneofs.get(f.oneof)
            if prev is not None and prev != name:
                self._values.pop(prev, None)
            self._oneofs[f.oneof] = name
        self._lazy.discard(name)
        self._values[name] = value

    def WhichOneof(self, group: str) -> Optional[str]:
        return self._oneofs.get(group)

    def HasField(self, name: str) -> bool:
        if name not in self._values:
            return False
        return name not in self._lazy or bool(self._values[name].SerializeToString())

    def _value(self, f: Field):
        if f.name in self._values and (not f.is_message or f.repeated or self.HasField(f.name)):
            return self._values[f.name]
        return None if f.is_message else _DEFAULTS.get(f.kind, 0)

    def __eq__(self, other) -> bool:
        if type(other) is not type(self):
            return NotImplemented
        return all(self._value(f) == other._value(f) for f in self.FIELDS) and \
            self._oneofs == other._oneofs

    def __repr__(self) -> str:
        parts = [f"{k}={v!r}" for k, v in self._values.items() if v or v == 0]
        return f"{type(self).__name__}({', '.join(parts)})"

    # -- encoding ------------------------------------------------------------
    def SerializeToString(self) -> bytes:
        out = bytearray()
        for f in self.FIELDS:
            if f.name not in self._values:
                continue
            value = self._values[f.name]
            if f.is_map:
                # an entry carries its key and its value, defaults included
                for key, sub in value.items():
                    entry = b"\x0a" + _len_prefixed(key.encode("utf-8")) + \
                        b"\x12" + _len_prefixed(sub.SerializeToString())
                    out += encode_varint(f.number << 3 | LENGTH) + _len_prefixed(entry)
            elif f.is_message:
                if not f.repeated and not self.HasField(f.name):
                    continue
                items = value if f.repeated else [value]
                for sub in items:
                    out += encode_varint(f.number << 3 | LENGTH) + _len_prefixed(
                        sub.SerializeToString())
            elif f.repeated:
                if not value:
                    continue
                if f.kind in ("string", "bytes"):
                    for v in value:
                        b = v.encode("utf-8") if f.kind == "string" else bytes(v)
                        out += encode_varint(f.number << 3 | LENGTH) + _len_prefixed(b)
                else:
                    body = b"".join(_scalar_bytes(f.kind, v) for v in value)
                    out += encode_varint(f.number << 3 | LENGTH) + _len_prefixed(body)
            else:
                if f.oneof is None and value == _DEFAULTS.get(f.kind, 0):
                    continue
                if f.kind in ("string", "bytes"):
                    b = value.encode("utf-8") if f.kind == "string" else bytes(value)
                    out += encode_varint(f.number << 3 | LENGTH) + _len_prefixed(b)
                else:
                    out += encode_varint(f.number << 3 | _WIRE[f.kind]) + \
                        _scalar_bytes(f.kind, value)
        return bytes(out)

    # -- decoding ------------------------------------------------------------
    @classmethod
    def FromString(cls, data: bytes) -> "Message":
        msg = cls()
        msg.MergeFromString(data)
        return msg

    def MergeFromString(self, data: bytes) -> None:
        by_number = {f.number: f for f in self.FIELDS}
        pos, n = 0, len(data)
        while pos < n:
            key, pos = decode_varint(data, pos)
            number, wire = key >> 3, key & 7
            f = by_number.get(number)
            if f is None:
                pos = _skip(data, pos, wire)
                continue
            if wire == LENGTH:
                size, pos = decode_varint(data, pos)
                chunk = data[pos:pos + size]
                if len(chunk) != size:
                    raise DecodeError("truncated length-delimited field")
                pos += size
                self._merge_length(f, chunk)
            else:
                if f.is_message or f.is_map or f.kind in ("string", "bytes"):
                    raise DecodeError(f"field {f.name}: wire type {wire}")
                value, pos = self._read_scalar(f.kind, wire, data, pos)
                if f.repeated:
                    self._values[f.name].append(value)
                else:
                    setattr(self, f.name, value)
        if pos != n:
            raise DecodeError("truncated message")

    @staticmethod
    def _read_scalar(kind: str, wire: int, data: bytes, pos: int):
        if wire == VARINT:
            v, pos = decode_varint(data, pos)
            return _from_varint(kind, v), pos
        if wire == FIXED32:
            if pos + 4 > len(data):
                raise DecodeError("truncated fixed32")
            return struct.unpack_from("<f", data, pos)[0], pos + 4
        if wire == FIXED64:
            if pos + 8 > len(data):
                raise DecodeError("truncated fixed64")
            return struct.unpack_from("<d", data, pos)[0], pos + 8
        raise DecodeError(f"wire type {wire} for a {kind}")

    def _merge_length(self, f: Field, chunk: bytes) -> None:
        if f.is_map:
            key, value = "", f.kind[1]()
            pos = 0
            while pos < len(chunk):
                k, pos = decode_varint(chunk, pos)
                if k >> 3 in (1, 2) and k & 7 == LENGTH:
                    size, pos = decode_varint(chunk, pos)
                    part = chunk[pos:pos + size]
                    pos += size
                    if k >> 3 == 1:
                        key = _utf8(part)
                    else:
                        value = f.kind[1].FromString(part)
                else:
                    pos = _skip(chunk, pos, k & 7)
            self._values[f.name][key] = value
        elif f.is_message:
            sub = f.kind.FromString(chunk)
            if f.repeated:
                self._values[f.name].append(sub)
            elif self.HasField(f.name):
                self._values[f.name].MergeFromString(chunk)
            else:
                setattr(self, f.name, sub)
        elif f.kind == "string":
            value = _utf8(chunk)
            if f.repeated:
                self._values[f.name].append(value)
            else:
                setattr(self, f.name, value)
        elif f.kind == "bytes":
            if f.repeated:
                self._values[f.name].append(bytes(chunk))
            else:
                setattr(self, f.name, bytes(chunk))
        else:
            # a packed run of numeric values
            target = self._values[f.name] if f.repeated else None
            pos = 0
            wire = _WIRE[f.kind]
            while pos < len(chunk):
                value, pos = self._read_scalar(f.kind, wire, chunk, pos)
                if target is not None:
                    target.append(value)
                else:
                    setattr(self, f.name, value)


def _utf8(raw: bytes) -> str:
    try:
        return bytes(raw).decode("utf-8")
    except UnicodeDecodeError as e:
        raise DecodeError(f"string field is not UTF-8: {e}") from None


# -- protos/kserve.proto ------------------------------------------------------

class ServerLiveRequest(Message):
    FIELDS = ()


class ServerLiveResponse(Message):
    FIELDS = (Field(1, "live", "bool"),)


class ServerReadyRequest(Message):
    FIELDS = ()


class ServerReadyResponse(Message):
    FIELDS = (Field(1, "ready", "bool"),)


class ModelReadyRequest(Message):
    FIELDS = (Field(1, "name", "string"), Field(2, "version", "string"))


class ModelReadyResponse(Message):
    FIELDS = (Field(1, "ready", "bool"),)


class ModelMetadataRequest(Message):
    FIELDS = (Field(1, "name", "string"), Field(2, "version", "string"))


class TensorMetadata(Message):
    FIELDS = (Field(1, "name", "string"), Field(2, "datatype", "string"),
              Field(3, "shape", "int64", repeated=True))


class ModelMetadataResponse(Message):
    TensorMetadata = TensorMetadata
    FIELDS = (Field(1, "name", "string"), Field(2, "versions", "string", repeated=True),
              Field(3, "platform", "string"),
              Field(4, "inputs", TensorMetadata, repeated=True),
              Field(5, "outputs", TensorMetadata, repeated=True))


class InferParameter(Message):
    FIELDS = (Field(1, "bool_param", "bool", oneof="parameter_choice"),
              Field(2, "int64_param", "int64", oneof="parameter_choice"),
              Field(3, "string_param", "string", oneof="parameter_choice"),
              Field(4, "double_param", "double", oneof="parameter_choice"))


class InferTensorContents(Message):
    FIELDS = (Field(1, "bool_contents", "bool", repeated=True),
              Field(2, "int_contents", "int32", repeated=True),
              Field(3, "int64_contents", "int64", repeated=True),
              Field(4, "uint_contents", "uint32", repeated=True),
              Field(5, "uint64_contents", "uint64", repeated=True),
              Field(6, "fp32_contents", "float", repeated=True),
              Field(7, "fp64_contents", "double", repeated=True),
              Field(8, "bytes_contents", "bytes", repeated=True))


_PARAMS = ("map", InferParameter)


class InferInputTensor(Message):
    FIELDS = (Field(1, "name", "string"), Field(2, "datatype", "string"),
              Field(3, "shape", "int64", repeated=True), Field(4, "parameters", _PARAMS),
              Field(5, "contents", InferTensorContents))


class InferRequestedOutputTensor(Message):
    FIELDS = (Field(1, "name", "string"), Field(2, "parameters", _PARAMS))


class ModelInferRequest(Message):
    InferInputTensor = InferInputTensor
    InferRequestedOutputTensor = InferRequestedOutputTensor
    FIELDS = (Field(1, "model_name", "string"), Field(2, "model_version", "string"),
              Field(3, "id", "string"), Field(4, "parameters", _PARAMS),
              Field(5, "inputs", InferInputTensor, repeated=True),
              Field(6, "outputs", InferRequestedOutputTensor, repeated=True),
              Field(7, "raw_input_contents", "bytes", repeated=True))


class InferOutputTensor(Message):
    FIELDS = (Field(1, "name", "string"), Field(2, "datatype", "string"),
              Field(3, "shape", "int64", repeated=True), Field(4, "parameters", _PARAMS),
              Field(5, "contents", InferTensorContents))


class ModelInferResponse(Message):
    InferOutputTensor = InferOutputTensor
    FIELDS = (Field(1, "model_name", "string"), Field(2, "model_version", "string"),
              Field(3, "id", "string"), Field(4, "parameters", _PARAMS),
              Field(5, "outputs", InferOutputTensor, repeated=True),
              Field(6, "raw_output_contents", "bytes", repeated=True))


class ModelStreamInferResponse(Message):
    FIELDS = (Field(1, "error_message", "string"),
              Field(2, "infer_response", ModelInferResponse))


MESSAGES: Dict[str, type] = {
    c.__name__: c for c in (
        ServerLiveRequest, ServerLiveResponse, ServerReadyRequest, ServerReadyResponse,
        ModelReadyRequest, ModelReadyResponse, ModelMetadataRequest, ModelMetadataResponse,
        InferParameter, InferTensorContents, ModelInferRequest, ModelInferResponse,
        ModelStreamInferResponse)}
