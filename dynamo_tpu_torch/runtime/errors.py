"""Typed error taxonomy shared by engine, preprocessor and HTTP frontend.

The port's copy of the reference package's runtime/errors.py. The engine
and preprocessor raise typed errors carrying a stable ``code``; the
request plane propagates ``.code`` in its err frames
(request_plane/tcp.py), so the frontend classifies by type locally and by
code across the wire, never by matching message text. Every class
subclasses ValueError, and a typed 4xx-class failure is never retried.
"""

from __future__ import annotations

from typing import Tuple


class InvalidRequestError(ValueError):
    """The request itself is wrong (bad option, unsupported modality, ...)."""

    code = "invalid_request"
    http_status = 400
    err_type = "invalid_request_error"


class ContextLengthError(InvalidRequestError):
    """Prompt (or prompt + requested output) exceeds the model's context."""

    code = "context_length"
    err_type = "context_length_exceeded"


class GuidedRejectedError(InvalidRequestError):
    """A guided-decoding grammar the engine cannot (or will not) serve."""

    code = "guided_rejected"


# worker-side code -> (http status, OpenAI-style error type); the request
# plane delivers remote typed errors as RequestPlaneError(msg, code)
HTTP_BY_CODE = {
    InvalidRequestError.code: (400, InvalidRequestError.err_type),
    ContextLengthError.code: (400, ContextLengthError.err_type),
    GuidedRejectedError.code: (400, GuidedRejectedError.err_type),
    "no_responders": (503, "service_unavailable"),
    "circuit_open": (503, "service_unavailable"),
}


def http_status_for(exc: BaseException) -> Tuple[int, str]:
    """(status, err_type) for a request that failed before/while streaming."""
    if isinstance(exc, InvalidRequestError):
        return exc.http_status, exc.err_type
    entry = HTTP_BY_CODE.get(getattr(exc, "code", None))
    if entry is not None:
        return entry
    return 500, "internal_error"


def is_terminal(exc: BaseException) -> bool:
    """True when retrying cannot help (client error, not transport loss)."""
    if isinstance(exc, InvalidRequestError):
        return True
    code = getattr(exc, "code", None)
    return code in HTTP_BY_CODE and code != "no_responders"
