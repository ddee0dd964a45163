"""Generic tensor inference protocol: named tensors in, named tensors out.

The port's copy of the reference package's llm/protocols/tensor.py: models
registered with model_type "tensor" skip the tokenizer and the OpenAI
machinery; the KServe frontend (llm/grpc/service.py) converts
ModelInferRequest tensors to this wire form, the worker's handler computes
on numpy arrays, and the response converts back (raw byte contents when the
client asked with raw_input_contents).

Wire form (the port's codec over the request plane; bytes ride natively):
    request : {"op": "tensor", "id": str, "model": str,
               "tensors": [{"name", "datatype", "shape", "data": bytes}],
               "parameters": {...}}
    response: {"tensors": [...], "error": str (when it failed)}
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List

import numpy as np

# KServe v2 datatype name -> numpy dtype (BYTES handled separately)
DTYPES = {
    "BOOL": np.bool_,
    "INT8": np.int8, "INT16": np.int16, "INT32": np.int32, "INT64": np.int64,
    "UINT8": np.uint8, "UINT16": np.uint16, "UINT32": np.uint32,
    "UINT64": np.uint64,
    "FP16": np.float16, "FP32": np.float32, "FP64": np.float64,
}
_NP_TO_NAME = {np.dtype(v).name: k for k, v in DTYPES.items()}


@dataclasses.dataclass
class Tensor:
    name: str
    datatype: str          # KServe v2 name (FP32, INT64, BYTES, ...)
    shape: List[int]
    data: bytes            # C-order payload; BYTES = 4-byte-LE-len-prefixed

    @classmethod
    def from_numpy(cls, name: str, arr: np.ndarray) -> "Tensor":
        dt = _NP_TO_NAME.get(arr.dtype.name)
        if dt is None:
            raise ValueError(f"unsupported tensor dtype {arr.dtype}")
        return cls(name, dt, list(arr.shape), np.ascontiguousarray(arr).tobytes())

    @classmethod
    def from_bytes_list(cls, name: str, items: List[bytes],
                        shape: List[int]) -> "Tensor":
        out = b"".join(
            len(b).to_bytes(4, "little") + b for b in items
        )
        return cls(name, "BYTES", shape, out)

    def to_numpy(self) -> np.ndarray:
        if self.datatype == "BYTES":
            raise ValueError("BYTES tensors: use to_bytes_list()")
        dt = DTYPES.get(self.datatype)
        if dt is None:
            raise ValueError(f"unsupported tensor datatype {self.datatype!r}")
        return np.frombuffer(self.data, dtype=dt).reshape(self.shape)

    def to_bytes_list(self) -> List[bytes]:
        out, i = [], 0
        while i + 4 <= len(self.data):
            n = int.from_bytes(self.data[i:i + 4], "little")
            out.append(self.data[i + 4:i + 4 + n])
            i += 4 + n
        return out

    def to_obj(self) -> Dict[str, Any]:
        return {
            "name": self.name, "datatype": self.datatype,
            "shape": list(self.shape), "data": self.data,
        }

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "Tensor":
        return cls(obj["name"], obj["datatype"], list(obj["shape"]),
                   obj.get("data", b""))


@dataclasses.dataclass
class TensorRequest:
    request_id: str
    model: str
    tensors: List[Tensor] = dataclasses.field(default_factory=list)
    parameters: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def tensor(self, name: str) -> Tensor:
        for t in self.tensors:
            if t.name == name:
                return t
        raise KeyError(name)

    def to_obj(self) -> Dict[str, Any]:
        return {
            "op": "tensor",
            "id": self.request_id, "model": self.model,
            "tensors": [t.to_obj() for t in self.tensors],
            "parameters": self.parameters,
        }

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "TensorRequest":
        op = obj.get("op", "tensor")
        if op != "tensor":
            # the discriminator to_obj writes: a mis-routed request-plane
            # payload (chat/embed/image) must fail loudly here, not decode
            # into an empty tensor list
            raise ValueError(f"not a tensor request: op={op!r}")
        return cls(
            request_id=obj.get("id", ""), model=obj.get("model", ""),
            tensors=[Tensor.from_obj(t) for t in obj.get("tensors", [])],
            parameters=obj.get("parameters") or {},
        )


@dataclasses.dataclass
class TensorResponse:
    tensors: List[Tensor] = dataclasses.field(default_factory=list)
    error: str = ""

    def to_obj(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"tensors": [t.to_obj() for t in self.tensors]}
        if self.error:
            out["error"] = self.error
        return out

    @classmethod
    def from_obj(cls, obj: Dict[str, Any]) -> "TensorResponse":
        return cls(
            tensors=[Tensor.from_obj(t) for t in obj.get("tensors", [])],
            error=obj.get("error", ""),
        )
