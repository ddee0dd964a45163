"""KServe v2 gRPC frontend (service.py) on the port's own protobuf codec
(kserve.py) and HTTP/2 (runtime/http2.py)."""

from .service import KserveGrpcService

__all__ = ["KserveGrpcService"]
