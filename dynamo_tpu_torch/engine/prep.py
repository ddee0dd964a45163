"""Async host chunk prep: build chunk N+1's packed arrays under chunk N.

The port's copy of the reference package's engine/prep.py. Host-side prep
of a prefill chunk (bucket-padding its token / position / block-id arrays
and copying them to the device) is Python that would otherwise run
serially on the step executor between two chunks. ``ChunkPrep`` moves it
onto a prep thread of its own: the moment chunk N's forward is enqueued
(the device runs it asynchronously from there), the NEXT chunk's arrays
are built and uploaded while the device is still busy with chunk N.

Byte-identity with serial prep is structural, not best-effort:

- ``_build`` runs the engine's own ``_chunk_arrays`` (the one packing
  routine behind prefill and mixed chunks) on an immutable snapshot: the
  prompt token ids and the chunk span's prompt-region block ids are both
  fixed at admission;
- ``take()`` hands a prebuilt result over ONLY when the serial path's key
  (request id, chunk start, chunk length, the chunk's tokens, the exact
  block-id list) matches the snapshot the build used. Any divergence
  (cancellation, block-table surgery) misses silently and the caller packs
  serially.

The engine's ``upload`` enqueues each array's copy from pinned host memory
on the stream its step executor launches on (engine/engine.py
``_prep_upload``), so the copy is ordered before the dispatch that reads
it; PyTorch's pinned-memory allocator keeps the host buffer until the copy
has run.

``DTPU_ASYNC_PREP`` (default on) gates the pipeline; ``StepStats`` carries
``prep_hit`` / ``prep_build_s`` / ``prep_wait_s`` so the step telemetry
shows how much host prep actually overlapped.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional, Tuple

from ..runtime.config import ENV_ASYNC_PREP


def async_prep_enabled() -> bool:
    return os.environ.get(ENV_ASYNC_PREP, "1").lower() not in (
        "0", "", "false", "off"
    )


class ChunkPrep:
    """One per engine. ``schedule()`` is called from the dispatch executor
    right after a chunk's device call is in flight; ``take()`` is called by
    the next chunk's dispatch. Keys are exact-match, so a stale or wrong
    prebuild can never change what the device sees."""

    def __init__(
        self,
        chunk_arrays: Callable,          # engine._chunk_arrays (pure)
        upload: Optional[Callable] = None,  # array -> device tensor; None = host-only
    ):
        self._chunk_arrays = chunk_arrays
        self._upload = upload
        self._ex = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-prep"
        )
        # request_id -> (key, Future[(arrays, uploads, build_s)])
        self._pending: Dict[str, Tuple[tuple, Future]] = {}
        # stats of the most recent take(), consumed by engine._step_stats
        self.last: Optional[Dict[str, Any]] = None

    @staticmethod
    def _key(rid: str, token_ids, start: int, chunk_len: int,
             block_ids) -> tuple:
        # content-exact over precisely what _chunk_arrays reads: the
        # chunk's token SLICE (so a reused request id with an edited
        # prompt can never key-match a stale prebuild) plus the block-id
        # list. O(chunk) — same order as the packing it guards.
        return (
            rid, int(start), int(chunk_len),
            tuple(token_ids[start : start + chunk_len]),
            tuple(block_ids),
        )

    def _build(self, token_ids, start: int, chunk_len: int, block_ids):
        t0 = time.perf_counter()
        arrays = self._chunk_arrays(token_ids, start, chunk_len, block_ids)
        uploads = (
            tuple(self._upload(a) for a in arrays)
            if self._upload is not None else None
        )
        return arrays, uploads, time.perf_counter() - t0

    def schedule(self, rid: str, token_ids, start: int, chunk_len: int,
                 block_ids) -> None:
        """Prebuild (and pre-upload) one chunk. ``token_ids`` must be a
        list the caller will not mutate (the engine passes the fresh list
        ``Sequence.tokens()`` builds per call — no copy needed here, and a
        full-prompt copy per chunk would be O(prompt^2) per request);
        ``block_ids`` IS snapshotted (the engine mutates that list)."""
        if len(self._pending) > 64:
            # stale entries (cancelled/reaped requests) are bounded, not
            # tracked: correctness never depends on the cache's contents
            self._pending.clear()
        blocks = list(block_ids)
        key = self._key(rid, token_ids, start, chunk_len, blocks)
        self._pending[rid] = (
            key,
            self._ex.submit(self._build, token_ids, start, chunk_len, blocks),
        )

    def take(self, rid: str, token_ids, start: int, chunk_len: int,
             block_ids):
        """The prebuilt (arrays, uploads) for an exactly-matching chunk, or
        None (caller packs serially). Waits for an in-flight build — even a
        partial overlap beats rebuilding from scratch."""
        ent = self._pending.pop(rid, None)
        if ent is None:
            self.last = None
            return None
        key, fut = ent
        if key != self._key(rid, token_ids, start, chunk_len, block_ids):
            self.last = {"hit": False, "build_s": 0.0, "wait_s": 0.0}
            return None
        t0 = time.perf_counter()
        try:
            arrays, uploads, build_s = fut.result()
        except Exception:
            # a prep failure must never take the dispatch down; the serial
            # path recomputes (and surfaces any real packing error)
            self.last = {"hit": False, "build_s": 0.0, "wait_s": 0.0}
            return None
        self.last = {
            "hit": True,
            "build_s": build_s,
            "wait_s": time.perf_counter() - t0,
        }
        return arrays, uploads

    def pop_last(self) -> Optional[Dict[str, Any]]:
        last, self.last = self.last, None
        return last

    def stop(self) -> None:
        self._ex.shutdown(wait=False)
