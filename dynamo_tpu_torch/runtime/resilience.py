"""Retry with backoff: the connect retries of the store and request plane.

The port's form of ``RetryPolicy`` and ``retry_policy`` from the reference
package's runtime/resilience.py, cut to what the port's three call sites
use: bounded attempts with a doubling delay up to a cap, retrying only
transport-class failures (typed 4xx-class errors are never retried). The
reference's jitter, deadlines, ``DTPU_RETRY_*`` specs, retry counters and
circuit breakers wait for a caller (ROADMAP item 4b).
"""

from __future__ import annotations

import asyncio
import dataclasses
from typing import Any, Callable, Tuple, Type

from .errors import is_terminal
from .logging import get_logger

log = get_logger("runtime.resilience")

# transient transport-class failures; typed application errors (see
# runtime/errors.py) deliberately do NOT appear here
RETRYABLE_DEFAULT: Tuple[Type[BaseException], ...] = (
    ConnectionError,
    OSError,
    TimeoutError,
    asyncio.TimeoutError,
)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Up to ``max_attempts`` calls; the delay before retry n is
    ``min(max_delay_s, base_delay_s * 2 ** (n - 1))``."""

    name: str = "default"
    max_attempts: int = 3
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    retryable: Tuple[Type[BaseException], ...] = RETRYABLE_DEFAULT

    def is_retryable(self, exc: BaseException) -> bool:
        # typed terminal errors (runtime/errors.py) never retry, even under
        # a broad retryable tuple like (Exception,)
        return not is_terminal(exc) and isinstance(exc, self.retryable)

    async def acall(self, fn: Callable[..., Any], *args: Any) -> Any:
        """Await ``fn(*args)`` under the policy."""
        delay = self.base_delay_s
        for attempt in range(1, self.max_attempts + 1):
            try:
                return await fn(*args)
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                if attempt >= self.max_attempts or not self.is_retryable(e):
                    raise
                log.debug("%s: attempt %d/%d failed (%s); retrying in %.3fs",
                          self.name, attempt, self.max_attempts, e, delay)
            await asyncio.sleep(delay)
            delay = min(self.max_delay_s, 2.0 * delay)


def retry_policy(scope: str, **kw: Any) -> RetryPolicy:
    return RetryPolicy(name=scope, **kw)
