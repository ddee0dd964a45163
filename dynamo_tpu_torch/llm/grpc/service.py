"""KServe v2 gRPC inference frontend.

The port's copy of the reference package's llm/grpc/service.py: the same
discovered model pipelines the OpenAI HTTP frontend serves, exposed over the
standard v2 inference protocol (protos/kserve.proto): text in
("text_input" BYTES tensor), text out ("text_output"), with the generation
knobs as request parameters, token streaming through ModelStreamInfer, and
generic tensor models (model_type "tensor", llm/protocols/tensor.py).

The reference runs it on grpcio with protoc's message classes; the port
runs it on its own HTTP/2 and gRPC code (runtime/http2.py) with its own
protobuf codec (kserve.py), so a stock grpcio client gets the reference
server's replies, status codes and messages.
"""

from __future__ import annotations

from typing import AsyncIterator, Optional

import numpy as np

from ...runtime.engine import Context
from ...runtime.http2 import GrpcServer, StatusCode
from ...runtime.logging import get_logger
from ..discovery import ModelManager
from ..protocols.openai import CompletionRequest, new_request_id
from ..protocols.tensor import DTYPES, Tensor, TensorRequest, TensorResponse
from . import kserve as pb

# InferTensorContents field per KServe datatype (BYTES handled separately)
_CONTENTS_FIELD = {
    "BOOL": "bool_contents",
    "INT8": "int_contents", "INT16": "int_contents", "INT32": "int_contents",
    "INT64": "int64_contents",
    "UINT8": "uint_contents", "UINT16": "uint_contents",
    "UINT32": "uint_contents", "UINT64": "uint64_contents",
    # FP16 has NO typed contents field in the KServe v2 spec: conformant
    # clients must ship it via raw_input_contents
    "FP32": "fp32_contents", "FP64": "fp64_contents",
}

log = get_logger("llm.grpc")

SERVICE_NAME = "inference.GRPCInferenceService"


def _param(params, name: str, default=None):
    p = params.get(name)
    if p is None:
        return default
    which = p.WhichOneof("parameter_choice")
    return getattr(p, which) if which else default


class KserveGrpcService:
    def __init__(self, manager: ModelManager, host: str = "0.0.0.0", port: int = 0):
        self.manager = manager
        self.host = host
        self.port = port
        self._server: Optional[GrpcServer] = None

    # -- rpc handlers --------------------------------------------------------
    async def ServerLive(self, request, context) -> pb.ServerLiveResponse:
        return pb.ServerLiveResponse(live=True)

    async def ServerReady(self, request, context) -> pb.ServerReadyResponse:
        return pb.ServerReadyResponse(ready=bool(self.manager.list_models()))

    async def ModelReady(self, request, context) -> pb.ModelReadyResponse:
        pipe = self.manager.get(request.name)
        ready = pipe is not None and bool(pipe.client and pipe.client.instances)
        return pb.ModelReadyResponse(ready=ready)

    async def ModelMetadata(self, request, context) -> pb.ModelMetadataResponse:
        if self.manager.get(request.name) is None:
            await context.abort(
                StatusCode.NOT_FOUND, f"model '{request.name}' not found"
            )
        resp = pb.ModelMetadataResponse(
            name=request.name, versions=["1"], platform="dynamo_tpu"
        )
        inp = resp.inputs.add()
        inp.name, inp.datatype = "text_input", "BYTES"
        inp.shape.append(1)
        out = resp.outputs.add()
        out.name, out.datatype = "text_output", "BYTES"
        out.shape.append(1)
        return resp

    @staticmethod
    def _is_tensor_model(pipe) -> bool:
        return "tensor" in (pipe.card.model_type or [])

    def _to_preq(self, request: pb.ModelInferRequest, pipe=None):
        if pipe is None:
            pipe = self.manager.get(request.model_name)
        if pipe is None:
            return None, None
        text = ""
        input_ids = None
        max_tokens = _param(request.parameters, "max_tokens")
        temperature = _param(request.parameters, "temperature")
        ignore_eos = _param(request.parameters, "ignore_eos")
        for t in request.inputs:
            if t.name == "text_input" and t.contents.bytes_contents:
                text = t.contents.bytes_contents[0].decode("utf-8", "replace")
            elif t.name == "input_ids" and t.contents.int64_contents:
                # pre-tokenized path: token ids skip the tokenizer entirely
                input_ids = [int(v) for v in t.contents.int64_contents]
            elif t.name == "max_tokens" and t.contents.int_contents:
                max_tokens = int(t.contents.int_contents[0])
            elif t.name == "temperature" and t.contents.fp32_contents:
                temperature = float(t.contents.fp32_contents[0])
        if input_ids is not None:
            from ..protocols.common import (
                PreprocessedRequest,
                SamplingOptions,
                StopConditions,
            )

            # the text path gets these from the preprocessor; the
            # pre-tokenized path must enforce them itself so over-long
            # inputs fail with INVALID_ARGUMENT, not a remote engine error
            budget = pipe.card.context_length - len(input_ids)
            if budget <= 0:
                raise ValueError(
                    f"input_ids length {len(input_ids)} exceeds model "
                    f"context {pipe.card.context_length}"
                )
            preq = PreprocessedRequest(
                request_id=request.id or new_request_id(),
                model=request.model_name,
                token_ids=input_ids,
                stop=StopConditions(
                    max_tokens=(
                        min(int(max_tokens), budget) if max_tokens else budget
                    ),
                    ignore_eos=bool(ignore_eos) if ignore_eos is not None else False,
                ),
                sampling=SamplingOptions(
                    temperature=(
                        float(temperature) if temperature is not None else 1.0
                    ),
                ),
            )
            return pipe, preq
        oai = CompletionRequest(
            model=request.model_name,
            prompt=text,
            max_tokens=int(max_tokens) if max_tokens else None,
            temperature=float(temperature) if temperature is not None else None,
            ignore_eos=bool(ignore_eos) if ignore_eos is not None else None,
        )
        preq = pipe.preprocessor.preprocess_completion(oai, text)
        if request.id:
            preq.request_id = request.id
        return pipe, preq

    # -- generic tensor models (llm/protocols/tensor.py) ---------------------
    @staticmethod
    def _pb_to_tensor_request(request: pb.ModelInferRequest) -> TensorRequest:
        tensors = []
        raw = list(request.raw_input_contents)
        if raw and len(raw) != len(request.inputs):
            raise ValueError(
                f"raw_input_contents has {len(raw)} entries for "
                f"{len(request.inputs)} inputs"
            )
        for i, t in enumerate(request.inputs):
            shape = [int(s) for s in t.shape]
            if raw:
                if t.datatype != "BYTES":
                    dt = DTYPES.get(t.datatype)
                    if dt is None:
                        raise ValueError(f"unsupported datatype {t.datatype!r}")
                    want = int(np.prod(shape)) * np.dtype(dt).itemsize
                    if len(raw[i]) != want:
                        raise ValueError(
                            f"tensor {t.name!r}: raw payload {len(raw[i])}B "
                            f"!= shape/dtype size {want}B"
                        )
                tensors.append(Tensor(t.name, t.datatype, shape, raw[i]))
            elif t.datatype == "BYTES":
                tensors.append(Tensor.from_bytes_list(
                    t.name, list(t.contents.bytes_contents), shape
                ))
            else:
                field = _CONTENTS_FIELD.get(t.datatype)
                if field is None:
                    raise ValueError(f"unsupported datatype {t.datatype!r}")
                vals = getattr(t.contents, field)
                arr = np.asarray(list(vals), DTYPES[t.datatype]).reshape(shape)
                tensors.append(Tensor.from_numpy(t.name, arr))
        params = {}
        for name in request.parameters:
            params[name] = _param(request.parameters, name)
        return TensorRequest(
            request_id=request.id or new_request_id(),
            model=request.model_name, tensors=tensors, parameters=params,
        )

    @staticmethod
    def _tensor_to_pb(
        request: pb.ModelInferRequest, tresp: TensorResponse, set_raw: bool
    ) -> pb.ModelInferResponse:
        resp = pb.ModelInferResponse(
            model_name=request.model_name, model_version="1", id=request.id
        )
        for t in tresp.tensors:
            out = resp.outputs.add()
            out.name, out.datatype = t.name, t.datatype
            out.shape.extend(t.shape)
            if set_raw:
                resp.raw_output_contents.append(t.data)
            elif t.datatype == "BYTES":
                out.contents.bytes_contents.extend(t.to_bytes_list())
            else:
                field = _CONTENTS_FIELD[t.datatype]
                getattr(out.contents, field).extend(
                    t.to_numpy().reshape(-1).tolist()
                )
        return resp

    async def _tensor_infer(
        self, pipe, request: pb.ModelInferRequest
    ) -> pb.ModelInferResponse:
        treq = self._pb_to_tensor_request(request)
        ctx = Context(treq.request_id)
        tresp = TensorResponse()
        try:
            async for item in await pipe.client.generate(treq.to_obj(), ctx):
                tresp = TensorResponse.from_obj(item)
        finally:
            ctx.stop_generating()
        if tresp.error:
            raise ValueError(tresp.error)
        return self._tensor_to_pb(
            request, tresp, set_raw=bool(request.raw_input_contents)
        )

    @staticmethod
    def _text_response(request, text: str, finish: Optional[str]) -> pb.ModelInferResponse:
        resp = pb.ModelInferResponse(
            model_name=request.model_name, model_version="1", id=request.id
        )
        out = resp.outputs.add()
        out.name, out.datatype = "text_output", "BYTES"
        out.shape.append(1)
        out.contents.bytes_contents.append(text.encode())
        if finish:
            resp.parameters["finish_reason"].string_param = finish
        return resp

    async def ModelInfer(self, request, context) -> pb.ModelInferResponse:
        pipe0 = self.manager.get(request.model_name)
        if pipe0 is not None and self._is_tensor_model(pipe0):
            # generic tensor model: tensors in, tensors out, no tokenizer
            # (reference grpc/service/tensor.rs)
            try:
                return await self._tensor_infer(pipe0, request)
            except (ValueError, KeyError) as e:
                await context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        try:
            pipe, preq = self._to_preq(request, pipe0)
        except ValueError as e:  # over-long prompt / bad params -> clean status
            await context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        if pipe is None:
            await context.abort(
                StatusCode.NOT_FOUND, f"model '{request.model_name}' not found"
            )
        ctx = Context(preq.request_id)
        parts = []
        finish = None
        try:
            async for out in pipe.generate_tokens(preq, ctx):
                if out.text:
                    parts.append(out.text)
                if out.finish_reason is not None:
                    finish = out.finish_reason
        finally:
            ctx.stop_generating()
        return self._text_response(request, "".join(parts), finish)

    async def ModelStreamInfer(
        self, request, context
    ) -> AsyncIterator[pb.ModelStreamInferResponse]:
        pipe0 = self.manager.get(request.model_name)
        if pipe0 is not None and self._is_tensor_model(pipe0):
            try:
                reply = await self._tensor_infer(pipe0, request)
                yield pb.ModelStreamInferResponse(infer_response=reply)
            except (ValueError, KeyError) as e:
                yield pb.ModelStreamInferResponse(error_message=str(e))
            return
        try:
            pipe, preq = self._to_preq(request, pipe0)
        except ValueError as e:
            await context.abort(StatusCode.INVALID_ARGUMENT, str(e))
        if pipe is None:
            await context.abort(
                StatusCode.NOT_FOUND, f"model '{request.model_name}' not found"
            )
        ctx = Context(preq.request_id)
        try:
            async for out in pipe.generate_tokens(preq, ctx):
                if out.text or out.finish_reason is not None:
                    yield pb.ModelStreamInferResponse(
                        infer_response=self._text_response(
                            request, out.text or "", out.finish_reason
                        )
                    )
        except Exception as e:  # stream errors ride the error_message field
            log.exception("stream infer failed")
            yield pb.ModelStreamInferResponse(error_message=str(e))
        finally:
            ctx.stop_generating()

    # -- server lifecycle ----------------------------------------------------
    def _register(self, server: GrpcServer) -> None:
        for name, req_cls, resp_cls, streaming in (
                ("ServerLive", pb.ServerLiveRequest, pb.ServerLiveResponse, False),
                ("ServerReady", pb.ServerReadyRequest, pb.ServerReadyResponse, False),
                ("ModelReady", pb.ModelReadyRequest, pb.ModelReadyResponse, False),
                ("ModelMetadata", pb.ModelMetadataRequest, pb.ModelMetadataResponse, False),
                ("ModelInfer", pb.ModelInferRequest, pb.ModelInferResponse, False),
                ("ModelStreamInfer", pb.ModelInferRequest, pb.ModelStreamInferResponse, True)):
            add = server.add_stream if streaming else server.add_unary
            add(f"/{SERVICE_NAME}/{name}", getattr(self, name), req_cls.FromString,
                resp_cls.SerializeToString)

    async def start(self) -> str:
        self._server = GrpcServer(self.host, self.port)
        self._register(self._server)
        self.port = await self._server.start()
        log.info("KServe gRPC frontend on %s:%d", self.host, self.port)
        return f"{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
