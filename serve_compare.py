#!/usr/bin/env python3
"""Gemma serving of one checkout on one GPU, with the host time spent
inside the unified attention wrapper summed: for comparing two commits
on one card back to back (unpack the parent with ``git archive`` into an
ignored directory and run parent, change, change, parent).

    python3 serve_compare.py CHECKOUT

Imports ``chip_smoke`` and ``dynamo_tpu_torch`` from CHECKOUT, builds its
kernels, then serves chip_smoke's Gemma traffic (``serve_gemma``:
gemma2-2b at full depth, random weights from a seed) three times on an
int8 cache and twice on a bf16 one, printing for each run its wall,
output tokens/s, TTFT and ITL medians and step counts, and the unified
wrapper's calls with their summed host time. The first int8 run is the
process's first serving run and pays its warm-up.
"""

import asyncio
import json
import sys
import time

import torch

sys.path.insert(0, sys.argv[1])
import chip_smoke as cs  # noqa: E402
from dynamo_tpu_torch.ops import _build, cuda_unified  # noqa: E402

_build.build_all()
real = cuda_unified.ragged_paged_attention
acc = {"n": 0, "s": 0.0}


def timed(*a, **k):
    t = time.perf_counter()
    try:
        return real(*a, **k)
    finally:
        acc["n"] += 1
        acc["s"] += time.perf_counter() - t


cuda_unified.ragged_paged_attention = timed
for int8 in (True, True, True, False, False):
    acc.update(n=0, s=0.0)
    r = asyncio.run(cs.serve_gemma(torch, int8=int8))
    keys = ("wall_s", "output_tok_s", "ttft_s_median", "itl_s_median", "steps")
    print("int8" if int8 else "bf16", json.dumps({k: r[k] for k in keys}),
          "wrapper calls", acc["n"], "host ms in wrapper %.1f (%.1f us/call)"
          % (acc["s"] * 1e3, acc["s"] * 1e6 / max(acc["n"], 1)), flush=True)
