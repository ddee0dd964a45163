"""Worker-side Backend operator: detokenization + stop-condition handling.

The port's copy of the reference package's llm/backend.py, with the
stop-string "jail" that holds back text which might still complete a stop
sequence. One engine output (a decode horizon's worth of tokens) becomes
one BackendOutput, as in the reference.

Wraps a token engine: takes PreprocessedRequest objects off the request plane,
streams BackendOutput objects back with incremental text attached and stop
strings enforced exactly (the emitted text never contains the stop string).
With tracing on, each request's stream runs under a ``worker.generate``
span parented on its ``traceparent`` annotation.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, List, Optional, Tuple

from ..runtime.engine import AsyncEngine, Context
from ..runtime.logging import get_logger
from ..runtime.tracing import get_tracer
from .protocols.common import FINISH_STOP, BackendOutput, PreprocessedRequest
from .tokenizer import DecodeStream, Tokenizer

log = get_logger("llm.backend")


class StopStringJail:
    """Text-side stop handling with partial-match holdback."""

    def __init__(self, stop_strings: List[str]):
        self._stops = [s for s in stop_strings if s]
        self._held = ""
        self._max_len = max((len(s) for s in self._stops), default=0)

    def push(self, delta: str) -> Tuple[str, bool]:
        """Returns (text safe to emit, hit_stop)."""
        if not self._stops:
            return delta, False
        buf = self._held + delta
        # full match anywhere in the buffer -> emit up to match, stop
        best: Optional[int] = None
        for s in self._stops:
            idx = buf.find(s)
            if idx != -1 and (best is None or idx < best):
                best = idx
        if best is not None:
            self._held = ""
            return buf[:best], True
        # hold back the longest suffix that is a proper prefix of any stop
        hold = 0
        max_check = min(len(buf), self._max_len - 1)
        for k in range(max_check, 0, -1):
            suffix = buf[len(buf) - k :]
            if any(s.startswith(suffix) for s in self._stops):
                hold = k
                break
        if hold:
            self._held = buf[len(buf) - hold :]
            return buf[: len(buf) - hold], False
        self._held = ""
        return buf, False

    def flush(self) -> str:
        out, self._held = self._held, ""
        return out


class Backend:
    """Operator: engine's raw token stream -> detokenized, stop-enforced stream."""

    def __init__(self, engine: AsyncEngine, tokenizer: Tokenizer):
        self.engine = engine
        self.tokenizer = tokenizer

    def _token_entry(self, tid: int, lp: float) -> dict:
        s = self.tokenizer.decode([tid], skip_special_tokens=False)
        return {"token": s, "logprob": lp, "bytes": list(s.encode("utf-8"))}

    def _logprob_entries(
        self,
        emit_ids: List[int],
        logprobs: Optional[List[float]],
        top_logprobs: Optional[List[dict]],
        n_top: int,
    ) -> Optional[List[dict]]:
        """OpenAI-shaped logprob entries, one per emitted token: the chosen
        token's own (token, logprob, bytes) plus the top-N alternatives,
        sorted descending. The chosen token is guaranteed present: when it
        falls outside the engine's top-N it is appended as an N+1th entry
        (vLLM semantics), so under greedy sampling it always leads the list."""
        if logprobs is None:
            return None
        entries: List[dict] = []
        for i, tid in enumerate(emit_ids):
            lp = float(logprobs[i]) if i < len(logprobs) else 0.0
            entry = self._token_entry(tid, lp)
            if n_top > 0 and top_logprobs is not None and i < len(top_logprobs):
                alts = {int(t): float(v) for t, v in top_logprobs[i].items()}
                chosen_lp = alts.pop(tid, lp)
                # top-n of the *other* candidates + the chosen token: when the
                # chosen was in the engine's top-n this yields exactly n rows,
                # otherwise n+1 rows with the chosen ranked last
                merged = sorted(alts.items(), key=lambda kv: -kv[1])[:n_top]
                merged.append((tid, chosen_lp))
                merged.sort(key=lambda kv: -kv[1])
                entry["top_logprobs"] = [
                    self._token_entry(int(t), float(v)) for t, v in merged
                ]
            else:
                entry["top_logprobs"] = []
            entries.append(entry)
        return entries

    async def generate(self, request: Any, context: Context) -> AsyncIterator[Any]:
        req = (request if isinstance(request, PreprocessedRequest)
               else PreprocessedRequest.from_obj(request))
        # tracing: continue the frontend's trace across the request-plane
        # hop (runtime/tracing.py)
        tracer = get_tracer()
        if not tracer.enabled:
            async for item in self._generate(req, context):
                yield item
            return
        with tracer.span("worker.generate", traceparent=req.annotations.get("traceparent"),
                         request_id=req.request_id):
            async for item in self._generate(req, context):
                yield item

    async def _generate(self, req: PreprocessedRequest, context: Context
                        ) -> AsyncIterator[Any]:
        decode = DecodeStream(self.tokenizer)
        jail = StopStringJail(req.stop.stop_strings)
        stop_token_ids = set(req.stop.stop_token_ids)
        if not req.stop.ignore_eos and self.tokenizer.eos_token_id is not None:
            stop_token_ids.add(self.tokenizer.eos_token_id)
        max_tokens = req.stop.max_tokens
        produced = 0
        finished = False

        async for step in self.engine.generate(req, context):
            out = step if isinstance(step, BackendOutput) else BackendOutput.from_obj(step)
            emit_ids: List[int] = []
            finish: Optional[str] = out.finish_reason
            for tid in out.token_ids:
                if finished:
                    break
                produced += 1
                if tid in stop_token_ids and produced > req.stop.min_tokens:
                    finish = FINISH_STOP
                    finished = True
                    break  # eos/stop token excluded from output
                emit_ids.append(tid)
                if max_tokens is not None and produced >= max_tokens:
                    finish = finish or "length"
                    finished = True
                    break
            text_delta = decode.step(emit_ids) if emit_ids else ""
            hit = False
            if text_delta or finish:
                text_delta, hit = jail.push(text_delta)
                if hit:
                    finish = FINISH_STOP
                    finished = True
                elif finish is not None:
                    # generation over without completing a stop string: release
                    # everything held back (jail prefixes + split UTF-8 tail)
                    tail, hit = jail.push(decode.flush())
                    if hit:
                        text_delta += tail
                    else:
                        text_delta += tail + jail.flush()
            entries = None
            if (req.sampling.want_logprobs or req.sampling.logprobs > 0) and emit_ids:
                entries = self._logprob_entries(
                    emit_ids, out.logprobs, out.top_logprobs, req.sampling.logprobs
                )
            yield BackendOutput(
                token_ids=emit_ids,
                text=text_delta,
                finish_reason=finish,
                cumulative_tokens=produced,
                logprobs=out.logprobs,
                top_logprobs=out.top_logprobs,
                logprob_entries=entries,
                annotations=out.annotations,
                kv_transfer=out.kv_transfer,
            ).to_obj()
            if finish is not None:
                if out.finish_reason is None:
                    # the engine knows nothing of the stop token, stop string
                    # or max_tokens that ended the stream here: stop it, so
                    # that it frees the slot now rather than at the request's
                    # own limit
                    context.stop_generating()
                return
            if context.is_stopped():
                yield BackendOutput(
                    finish_reason="cancelled", cumulative_tokens=produced
                ).to_obj()
                return
