"""Performance recording + analysis of streaming responses.

The port's copy of the reference package's llm/perf.py: wrap any token
stream to record timestamped responses with minimal overhead, then analyze
offline: TTFT/ITL percentiles, throughput, and logprob sensitivity (how
close sampling came to picking a different token).
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, AsyncIterator, Dict, List, Optional, Tuple


@dataclasses.dataclass
class TimestampedResponse:
    response: Any
    elapsed_s: float        # since stream start
    sequence_number: int


@dataclasses.dataclass
class RecordedStream:
    """The recording a wrapped stream leaves behind."""

    responses: List[TimestampedResponse] = dataclasses.field(default_factory=list)
    started_at: float = 0.0
    ended_at: float = 0.0

    @property
    def response_count(self) -> int:
        return len(self.responses)

    @property
    def total_duration_s(self) -> float:
        return max(self.ended_at - self.started_at, 0.0)

    # -- analysis ------------------------------------------------------------
    def token_timestamps(self) -> List[float]:
        """Per-token arrival times (a multi-token response's tokens share
        its timestamp — horizon emission)."""
        out: List[float] = []
        for r in self.responses:
            ids = getattr(r.response, "token_ids", None)
            if ids is None and isinstance(r.response, dict):
                ids = r.response.get("token_ids")
            for _ in ids or []:
                out.append(r.elapsed_s)
        return out

    def analyze(self) -> Dict[str, float]:
        ts = self.token_timestamps()
        if not ts:
            return {"tokens": 0}
        itls = [b - a for a, b in zip(ts, ts[1:]) if b > a]
        itls.sort()

        def pct(xs: List[float], p: float) -> float:
            return xs[min(len(xs) - 1, int(p * len(xs)))] if xs else 0.0

        dur = self.total_duration_s or ts[-1] or 1e-9
        return {
            "tokens": len(ts),
            "ttft_s": round(ts[0], 6),
            "itl_mean_s": round(sum(itls) / len(itls), 6) if itls else 0.0,
            "itl_p50_s": round(pct(itls, 0.50), 6),
            "itl_p95_s": round(pct(itls, 0.95), 6),
            "tokens_per_s": round(len(ts) / dur, 3),
            "duration_s": round(dur, 6),
        }


async def record_stream(
    stream: AsyncIterator[Any],
    recording: Optional[RecordedStream] = None,
) -> AsyncIterator[Any]:
    """Pass-through wrapper stamping every response (collection stays
    cheap; analysis happens after the stream ends)."""
    rec = recording if recording is not None else RecordedStream()
    rec.started_at = time.monotonic()
    seq = 0
    try:
        async for item in stream:
            rec.responses.append(TimestampedResponse(
                item, time.monotonic() - rec.started_at, seq
            ))
            seq += 1
            yield item
    finally:
        rec.ended_at = time.monotonic()


# ---------------------------------------------------------------------------
# logprob sensitivity
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PositionCloseness:
    position: int
    selected_token: int
    selected_logprob: float
    runner_up_token: Optional[int]
    margin: float               # logprob gap to the runner-up (inf if none)

    @property
    def prob_ratio(self) -> float:
        """P(runner_up)/P(selected): 1.0 = a coin flip, 0 = deterministic."""
        return math.exp(-self.margin) if math.isfinite(self.margin) else 0.0


@dataclasses.dataclass
class SensitivityAnalysis:
    """How close each sampled position came to a different token."""

    positions: List[PositionCloseness]

    @property
    def close_calls(self) -> List[PositionCloseness]:
        return [p for p in self.positions if p.prob_ratio >= 0.5]

    @property
    def min_margin(self) -> float:
        return min((p.margin for p in self.positions), default=math.inf)

    def summary(self) -> Dict[str, Any]:
        return {
            "positions": len(self.positions),
            "close_calls": len(self.close_calls),
            "min_margin": round(self.min_margin, 6)
            if math.isfinite(self.min_margin) else None,
            "mean_prob_ratio": round(
                sum(p.prob_ratio for p in self.positions) / len(self.positions), 6
            ) if self.positions else 0.0,
        }


def analyze_logprobs(entries: List[Dict[str, Any]]) -> SensitivityAnalysis:
    """``logprob_entries`` from the backend (token, logprob, top_logprobs
    list of {token, logprob}) -> closeness per position."""
    positions: List[PositionCloseness] = []
    for n, e in enumerate(entries or []):
        sel_tok = e.get("token_id", e.get("token"))
        sel_lp = float(e.get("logprob", 0.0))
        runner: Tuple[Optional[int], float] = (None, math.inf)
        for alt in e.get("top_logprobs") or []:
            alt_tok = alt.get("token_id", alt.get("token"))
            if alt_tok == sel_tok:
                continue
            gap = sel_lp - float(alt.get("logprob", -math.inf))
            if gap < runner[1]:
                runner = (alt_tok, gap)
        positions.append(PositionCloseness(
            position=n, selected_token=sel_tok, selected_logprob=sel_lp,
            runner_up_token=runner[0], margin=max(runner[1], 0.0),
        ))
    return SensitivityAnalysis(positions)
