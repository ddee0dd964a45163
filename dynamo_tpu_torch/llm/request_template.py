"""Preset request defaults loaded from a JSON file.

The port's copy of the reference package's llm/request_template.py: a JSON
object with ``model``, ``temperature`` and ``max_completion_tokens``, given
to the frontend with ``--request-template FILE``, fills each field of a
chat or completions request only where the request left it unset, so
clients may omit them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional


@dataclasses.dataclass
class RequestTemplate:
    model: str = ""
    temperature: Optional[float] = None
    max_completion_tokens: Optional[int] = None

    @classmethod
    def load(cls, path: str) -> "RequestTemplate":
        with open(path) as f:
            raw = json.load(f)
        if not isinstance(raw, dict):
            raise ValueError(f"request template {path!r} must be a JSON object")
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"request template {path!r}: unknown keys {sorted(unknown)}"
            )
        return cls(**raw)

    def apply(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """Fill template values into a raw request body, request wins: each
        field is taken from the template only when the request left it
        unset (absent, null, or empty-string model)."""
        if not isinstance(body, dict):
            # let request validation produce its normal 400 for non-object
            # bodies instead of raising TypeError here
            return body
        out = dict(body)
        if self.model and not out.get("model"):
            out["model"] = self.model
        if self.temperature is not None and out.get("temperature") is None:
            out["temperature"] = self.temperature
        if (
            self.max_completion_tokens is not None
            and out.get("max_completion_tokens") is None
            and out.get("max_tokens") is None
        ):
            out["max_completion_tokens"] = self.max_completion_tokens
        return out
