#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase (what CI runs)
    python3 chip_smoke.py --phases kernels   # build + kernel checks only

Phases, in order; any failure raises and the exit code is not 0:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; builds every kernel of dynamo_tpu_torch/csrc from source.
2. kernels: each CUDA kernel against its plain PyTorch version at
   Llama-3-8B attention shapes (32 q heads, 8 kv heads, head_dim 128, block
   16) on ragged rows, the attention kernels on a bf16 and on an int8 cache,
   and the unified kernel at Gemma shapes (8 q heads, 4 kv heads, head_dim
   256) with per-row sliding windows, a softcap and sinks;
   times kernel, plain version, a PyTorch library call doing the same work
   (scaled_dot_product_attention over the gathered, dequantized KV; the
   port never calls it) and the card's bound; the unified kernel's
   split-K merge kernel against its plain version on partials shaped like
   a Gemma decode batch (and against a mutant that counts the sink once
   per split, which must fail), and one Gemma case whose short rows end in
   a split that some of their tokens never reach, with sinks on; each
   Gemma case reads the split counts the kernel wrote and holds them to
   the plain split plan. The build's SASS must hold
   tensor-core instructions (HGMMA or HMMA, cuobjdump) in the
   decode, flash-extend and unified kernels. The decode kernel runs the check
   batch, 8 rows at llama serving's 4096-key limit and one such row alone,
   each against its plain version (and the plain split form), with the
   split counts the kernel wrote held to the plain split plan, at least
   one working block per SM on the first two, a plain merge that drops
   each row's last split failing the compare, and SDPA and the unified
   kernel (as q_len = 1 rows) timed on the same rows. The page-copy
   kernel (gather, scatter, copy, the int8 pair in one launch, and the
   layer-batched gather_layers / scatter_layers over 32 Llama-3-8B layer
   caches in one launch) must be bit-exact on bf16 pages and on the int8
   pair, against index_select / index_copy_ as the library yardstick.
3. model: a 2-layer model at full Llama-3-8B width runs a prefill, decode
   steps and a ragged 2-token step through the model's attend hook, once
   with the kernels and once with the plain ops, on bf16 and on int8
   caches; the logits must agree, and three deliberately wrong attentions
   must not, on each of 3 seeds. The same for gemma2-2b (2 layers) and
   gemma3-4b (6 layers) at full width through the unified kernel, with
   the window dropped, one page too wide, or the softcap dropped as the
   wrong attentions.
4. serving (each engine with its defaults: the auto-tuned decode horizon,
   each horizon one CUDA-graph replay, and launches counted through the
   replays): TorchEngine on the llama3-8b preset at full depth (32 layers,
   random bf16 weights from a seed) serves staggered concurrent requests;
   every request must finish with its token count, and the decode,
   flash-extend and unified kernels and the fused mixed step must all have
   run during it. Then the same engine with the int8 KV cache and a KVBM
   host tier serves three waves (first, churn, repeat): the repeats
   onboard their evicted prefixes from the host tier; the int8 attention
   kernels and the layer-batched gather and scatter must all have run,
   one gather launch per offload batch and one scatter launch per
   onboard, and an onboarded block must re-encode bit-exactly to its
   stored bytes. Then
   gemma2-2b at full depth (26 layers, max_context 8192) serves 8
   staggered prompts of up to 8000 tokens on a bf16 cache and 3 on an int8
   cache: every request finishes, the unified kernel served windowed
   launches, split rows (by the kernel's own count, in the profiled
   runs) and neither the decode nor the flash-extend kernel ran.
5. horizon: the decode horizon. For llama3-8b on a bf16 and an int8 cache
   and gemma2-2b on bf16, one horizon of 8 steps from a random state run
   eagerly on cloned caches and its captured graph replayed on the
   originals must agree bit for bit (packed tokens and logprobs, carry,
   output counts, every K/V page but scratch block 0). Then llama3-8b at 32
   layers serves 8 prompts of 128 tokens queued at once, 256 output tokens
   each (one seeded sampled request), four times on one set of weights:
   (a) one eager decode step per tick, (b) eager horizons of 8, (c)
   graphed horizons of 8 with two in flight, (d) the auto-tuned schedule
   with graphs; (b)-(d) carry a stop token that one greedy request's (a)
   stream samples mid-horizon, and must stream exactly (a)'s tokens, cut at
   the stop. Prints each run's ITL, TTFT, tok/s and wall, captures,
   capture seconds, pool bytes, replays and launches through replays; (d)
   again under the profiler for the device-busy share; and the device time
   per step, inside a graph, of the Gumbel draw and the KV writes.
6. gptoss: gpt-oss-20b (64 q heads over 8 kv heads, head_dim 64, window
   128 on even layers, per-head sinks, 32 experts, top 4). (a) the unified
   kernel at d = 64, bf16 and int8, against its plain version: a decode
   batch of 8 rows of 1-8000 keys through a sliding layer (window 128) and
   through a full one, sinks on in both, the last 2048-token chunk of a
   6000-token prompt through a sliding layer, and a mixed step, keys
   planted at each windowed decode row's window edge, each case timed
   with its bound and compiled flex_attention with the sink and window as
   its library yardstick; the merge kernel at d = 64 against its plain
   version and its sink-per-split mutant. (b) the grouped expert FFN
   (``models/gptoss.experts_grouped``, torch._grouped_mm over the pairs
   sorted by expert) against the plain expert loop at full width, 8 and
   2048 tokens, timed against its byte and FLOP bounds, and captured into
   a CUDA graph whose replay equals its eager run bit for bit (the form
   the decode horizon captures). (c) the model check at full width and 2
   layers (sliding, full) with the grouped experts on the kernel path and
   the plain loop on the plain path: a sink-dropped mutant and a window
   one key too wide must fail it. (d) gpt-oss-20b at all 24 layers (random
   bf16 weights from seed 0, 41.8 GB) on its defaults: graph replay =
   eager horizon bit for bit on a bf16 and an int8 cache; decode-heavy
   traffic (8 x 128-token prompts, 64 tokens each) streaming the same
   tokens one step per tick and on the auto-tuned graphed schedule; a
   serving run of 8 prompts of 100-6000 tokens, 32 tokens each (one seeded
   sampled), again under the profiler, and a short int8 run: TTFT, ITL,
   tok/s, device busy share, graphs, capture seconds, pool bytes, launches
   through replays and peak device memory.
7. moe_mla: the MoE and MLA families. (a) the latent kernel
   (csrc/mla_attention.cu: one kv head of 576 lanes, 512 value lanes)
   against its plain version and its plain split form: its ptxas
   registers (no spill), blocks per SM and HMMA count; a decode batch of
   8 rows of 1-8000 keys at 16 query heads (DeepSeek-V2-Lite) and at 128
   (V2 / V3), each with >= 132 working blocks, the last 2048-token chunk
   of a 6000-token prompt, a mixed step (a chunk row and 8 decode rows),
   short rows whose last split some tokens never reach, the split counts
   the kernel wrote held to the plain split plan, and a plain merge that
   drops each row's last split failing the compare; each case timed with
   its bound and SDPA over the gathered latent (heads folded into the
   query axis) as its library yardstick. (b) the routed experts of
   Qwen3-30B-A3B (128, top 8) and of DeepSeek-V2-Lite (64, top 6, 2 shared)
   at full width, 8 and 2048 tokens, against the float32 expert loop per
   token row, timed against byte and FLOP bounds, and captured into a
   CUDA graph whose replay equals its eager run. (c) model checks at full
   width, 2 layers, routing pinned: DeepSeek-V2-Lite (one dense, one MoE
   layer) through the latent kernel, with the query pre-scale dropped and
   k_pe zeroed in the cache as the mutants; Qwen3-30B-A3B through kernels
   1-3 with the llama mutants. (d) DeepSeek-V2-Lite at all 27 layers
   (random bf16 weights, 31.4 GB, max_context 8192): graph replay = eager
   horizon bit for bit; 8 prompts of 100-6000 tokens 0.25 s apart, 32
   tokens each (one seeded sampled), again under the profiler; decode-heavy
   traffic (8 x 128-token prompts, 64 tokens each) one step per tick and
   on the auto-tuned graphed schedule (streaming the same tokens), the
   latter profiled: the latent kernel launched through graph replays and
   no other attention kernel ran. (e) Qwen3-30B-A3B at 12 of its 48 layers
   (full width; 61 GB at full depth leaves too little of the card) serves
   the same 8 prompts, 64 tokens each, through kernels 1-3 and the grouped
   experts. No ERROR log record in (d) or (e).
8. report: one JSON line with every kernel's numbers, the nvidia-smi line,
   and last the device line ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present or
when the dynamo_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import functools
import gc
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# dense bf16 tensor-core flop/s
HBM_BYTES_S = 3.35e12
BF16_FLOPS_S = 989e12
# kernel vs plain version, both bf16 out: bf16 keeps ~3 significant digits
# and the two sum in different orders and round at different points. Every
# element within KERNEL_ATOL + KERNEL_RTOL * |plain| (the worst error
# measured is 2.0e-3, on flash-extend rows of magnitude ~1), and every
# output row (one token, one head) within KERNEL_ROW_REL in relative L2
# norm: on rows of 1-2k keys, whose elements are ~0.03, the elementwise
# limit alone would pass a small systematic error such as a bad rescale.
KERNEL_ATOL, KERNEL_RTOL = 4e-3, 2e-2
KERNEL_ROW_REL = 2e-2
# model check: the last position's logits of the kernel path against the
# plain path, as ||kernels - plain|| / ||plain|| (a max elementwise diff of
# bf16-rounded logits sits a few rounding steps from any fixed limit). The
# same reading is taken for deliberately wrong attentions (MODEL_MUTANTS);
# the limit lies between the kernel path's readings and theirs (PERF.md).
MODEL_REL_TOL = 3e-2
MODEL_SEEDS = (1, 2, 3)
# Llama-3-8B attention shapes
H, KVH, D, BS = 32, 8, 128, 16


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing
class Timer:
    """Median over repeats of one call, timed with CUDA events. Before each
    repeat the 50 MB L2 cache is flushed (the serving path finds each
    layer's cache cold) and the GPU is kept busy for ~0.1 ms, so the host's
    work to launch the call overlaps that wait instead of landing between
    the two events."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(96 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 15, warmup: int = 2, busy: int = 200_000) -> float:
        """``busy``: GPU cycles to wait before the call; raise it for a call
        whose host work before its launch outlasts the default."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(busy)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def bound(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_S * 1e3
    t_ops = flops / BF16_FLOPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(torch, got, want, name: str) -> float:
    """Max abs error of a kernel's output against its plain version's;
    raises past the elementwise or the per-row limit."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (got - want).abs()
    limit = KERNEL_ATOL + KERNEL_RTOL * want.abs()
    norm = want.norm(dim=-1)
    row_rel = ((got - want).norm(dim=-1) / norm.clamp_min(1e-30))[norm > 0]
    worst_row = row_rel.max().item() if row_rel.numel() else 0.0
    if bool((err > limit).any()) or worst_row > KERNEL_ROW_REL:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs err "
            f"{err.max().item():.4g} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}), "
            f"worst row relative L2 {worst_row:.4g} (limit {KERNEL_ROW_REL})"
        )
    return err.max().item()


def ptxas_summary(build_log: str) -> list:
    """Each kernel of a `nvcc -Xptxas -v` log: its entry name (mangled,
    cut to 60 characters), registers, and spill stores and loads."""
    import re

    out, name = [], "?"
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)[:60]
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers, {spill}")
    return out


def unified_occupancy(_build) -> list:
    """(d, int8, blocks per SM, dynamic shared bytes) of the unified kernel
    at each head_dim it takes, from the occupancy calculator
    (dtt_unified_occupancy)."""
    import ctypes

    fn = _build.load("unified_attention.cu").dtt_unified_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = []
    for d in (64, 128, 256):
        for i8 in (0, 1):
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            err = fn(d, i8, ctypes.byref(blocks), ctypes.byref(smem))
            if err:
                raise AssertionError(f"occupancy of the unified kernel at d={d}: CUDA error {err}")
            out.append((d, bool(i8), blocks.value, smem.value))
    return out


# the libraries whose SASS must hold tensor-core instructions
TENSOR_CORE_LIBS = ("libdecode_attention.so", "libflash_extend.so", "libunified_attention.so",
                    "libmla_attention.so")


def tensor_core_instructions(out_dir: str) -> dict:
    """Counts HGMMA (wgmma) and HMMA (mma.sync) instructions in the SASS of
    the decode, flash-extend, unified and latent libraries (cuobjdump
    -sass) and fails if a library has none. Where the toolkit has no cuobjdump it says so."""
    import shutil

    tool = os.path.join(os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    if not os.path.exists(tool):
        tool = shutil.which("cuobjdump")
    if tool is None:
        log("SASS check: no cuobjdump in this CUDA toolkit; tensor-core instructions not counted")
        return {}
    counts = {}
    for lib in TENSOR_CORE_LIBS:
        sass = subprocess.run([tool, "-sass", os.path.join(out_dir, lib)], capture_output=True,
                              text=True, timeout=300, check=True).stdout
        counts[lib] = {op: sum(1 for l in sass.splitlines() if op + "." in l or op + " " in l)
                       for op in ("HGMMA", "HMMA")}
        log(f"SASS {lib}: {counts[lib]['HGMMA']} HGMMA, {counts[lib]['HMMA']} HMMA")
        if not sum(counts[lib].values()):
            raise AssertionError(f"{lib}: no tensor-core instruction in its SASS")
        if lib == "libunified_attention.so":
            # the head_dim 64 forms (gpt-oss) on their own
            per = {}
            for part in sass.split("Function : ")[1:]:
                name = part.split()[0]
                if "unified_kernelILi64E" in name:
                    per[name[:40]] = sum(1 for l in part.splitlines() if "HGMMA." in l)
            log(f"SASS {lib}, the d = 64 forms: {per}")
            if len(per) != 2 or not all(per.values()):
                raise AssertionError(f"{lib}: the d = 64 forms hold no HGMMA: {per}")
    return counts


# ------------------------------------------------------------- phase 2
def quantized(torch, cache):
    """A bf16 paged cache [nb, BS, kvh, D] quantized to the int8 format
    (ops/quant.quantize_blocks: int8 pages + f32 [nb, kvh] scales)."""
    from dynamo_tpu_torch.ops.quant import QuantizedKV, quantize_blocks

    return QuantizedKV(*quantize_blocks(cache))


def paged_case(torch, gen, lens, num_blocks, kvh=KVH, int8=False, d=D):
    """Random bf16 paged cache with each row on scrambled distinct pages
    (table padding -> scratch block 0); ``int8`` quantizes it."""
    dev = "cuda"
    kc = torch.randn(num_blocks, BS, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(num_blocks, BS, kvh, d, generator=gen, device=dev).to(torch.bfloat16)
    mb = max(-(-n // BS) for n in lens) + 4
    tables = np.zeros((len(lens), mb), np.int32)
    free = list(np.random.default_rng(0).permutation(np.arange(1, num_blocks)))
    for r, n in enumerate(lens):
        for j in range(-(-n // BS)):
            tables[r, j] = free.pop()
    if int8:
        kc, vc = quantized(torch, kc), quantized(torch, vc)
    return kc, vc, torch.as_tensor(tables, device=dev)


def kv_bytes(n_keys, kvh, int8, d=D):
    """Bytes of n_keys K and V rows of kvh heads: bf16 rows, or int8 rows
    plus the scale rows of their ceil(n / BS) pages (f32 per kv head)."""
    if int8:
        return 2 * (n_keys * kvh * d + 4 * -(-n_keys // BS) * kvh)
    return 2 * 2 * n_keys * kvh * d


def expand_kv(torch, kc, vc, table, T, h=H):
    """Gathered [T, h, d] K/V of one row with kv heads repeated to q heads
    (the library yardstick's input)."""
    from dynamo_tpu_torch.ops import attention as att

    k, v = att.gather_kv(kc, vc, table)   # an int8 cache dequantizes (f32)
    g = h // k.shape[1]
    return (k[:T].to(torch.bfloat16).repeat_interleave(g, dim=1).transpose(0, 1),
            v[:T].to(torch.bfloat16).repeat_interleave(g, dim=1).transpose(0, 1))


# decode kernel cases: the check batch (the lens of every earlier timing), rows at
# llama serving's 4096-key limit, and one such row alone
DECODE_CASES = {
    "check batch": [1, 17, 250, 999, 2100, 513, 77, 1500],
    "long rows": [3000, 4096, 3500, 3900, 3100, 4000, 3300, 3700],
    "one long row": [4096],
}
# the cases whose split-K must reach the SM count in working blocks
DECODE_FILL = ("check batch", "long rows")


def decode_case(torch, gen, timer, lens, int8, sms):
    """One decode case: the kernel against its plain version (and the plain
    split form), the split counts the kernel wrote against att.split_plan,
    the drop-last-split mutant of the plain merge (must fail the compare),
    and the times of the kernel, the plain version, SDPA and the unified
    kernel on the same rows as q_len = 1 rows."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_unified

    pages = sum(-(-n // BS) for n in lens)
    kc, vc, tables = paged_case(torch, gen, lens, num_blocks=pages + 64, int8=int8)
    B = len(lens)
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    i32 = dict(dtype=torch.int32, device="cuda")
    seq_lens = torch.tensor(lens, **i32)
    args = (q, kc, vc, tables, seq_lens)
    bound_kw = dict(max_seq_len=max(lens))
    tag = f"decode{' int8' if int8 else ''} {lens if B < 9 else B}"
    cuda_attention.split_log = []
    try:
        got = cuda_attention.paged_decode_attention(*args, **bound_kw)
        (grid, n_dev), = cuda_attention.split_log
    finally:
        cuda_attention.split_log = None
    err = compare(torch, got, att.paged_decode_attention(*args), tag)
    S = cuda_attention.split_extent(max(lens))
    compare(torch, got, att.split_paged_decode_attention(
        *args, split_keys=cuda_attention.DEC_SPLIT_KEYS, max_splits=S), tag + " (plain split)")
    n_kernel = n_dev.tolist()
    n_plain = [att.split_plan(1, n, 0, cuda_attention.DEC_SPLIT_KEYS, BS, S)[2] if S > 1
               else 0 for n in lens]
    if n_kernel != n_plain:
        raise AssertionError(f"{tag}: the kernel split its rows {n_kernel}, the plain split "
                             f"plan {n_plain}")
    blocks = KVH * sum(max(n, 1) for n in n_kernel)
    # the mutant: the plain merge without each split row's last split
    starts = torch.arange(B, dtype=torch.int32)
    ones = torch.ones(B, dtype=torch.int32)
    acc, m, l, n = att.attention_partials(
        q, kc, vc, tables, starts, ones, seq_lens.cpu(),
        split_keys=cuda_attention.DEC_SPLIT_KEYS, align=BS, max_splits=S)
    for r, c in enumerate(n.tolist()):
        if c >= 2:
            l[r, c - 1] = 0.0
    if not any(c >= 2 for c in n.tolist()):
        raise AssertionError(f"{tag}: no row is split")
    wrong = att.merge_attention_partials(acc, m, l, n, starts, ones, got.clone())
    try:
        compare(torch, got, wrong, tag + " against its drop-last-split mutant")
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{tag}: a merge without the last split passes the compare")
    del acc, m, l, wrong
    T = max(lens)
    ks, vs = zip(*(expand_kv(torch, kc, vc, tables[r], T) for r in range(B)))
    kl, vl = torch.stack(ks), torch.stack(vs)                  # [B, H, T, D]
    del ks, vs
    mask = (torch.arange(T, device="cuda")[None, :] < seq_lens[:, None])[:, None, None, :]
    ql = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    uargs = (q, kc, vc, tables, torch.arange(B, **i32), torch.ones(B, **i32), seq_lens)
    n_keys = sum(lens)
    b, by = bound(
        2 * 2 * B * H * D                       # q in, out
        + sum(kv_bytes(n, KVH, int8) for n in lens)   # K and V rows needed
        + 4 * (B + sum(-(-n // BS) for n in lens)),
        4 * n_keys * H * D,
    )
    ms = timer(lambda: cuda_attention.paged_decode_attention(*args, **bound_kw))
    out = {
        "lens": lens, "max_abs_err": err, "grid": grid, "splits_per_row": n_kernel,
        "working_blocks": blocks, "drop_last_split_mutant_fails": True,
        "ms": ms,
        "plain_ms": timer(lambda: att.paged_decode_attention(*args), reps=5),
        "library_ms": timer(lambda: sdpa(ql, kl, vl, attn_mask=mask)),
        "unified_ms": timer(lambda: cuda_unified.ragged_paged_attention(
            *uargs, max_q_len=1, **bound_kw)),
        "bound_ms": b, "bound_by": by, "achieved_tb_s": b / ms * HBM_BYTES_S / 1e12,
    }
    log(f"  {tag}: max abs err {err:.3g}; {ms:.4f} ms kernel, {out['plain_ms']:.4f} ms "
        f"plain, {out['library_ms']:.4f} ms SDPA, {out['unified_ms']:.4f} ms unified "
        f"(q_len 1 rows), bound {b:.4f} ms ({by}), {out['achieved_tb_s']:.2f} TB/s; grid "
        f"{grid}, splits per row {n_kernel} (the kernel's count), {blocks} working blocks "
        f"on {sms} SMs")
    return out


def check_decode(torch, gen, timer, int8=False):
    """The decode kernel on each DECODE_CASES case; the top-level numbers
    are the check batch's (the shapes every earlier run timed)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {name: decode_case(torch, gen, timer, lens, int8, sms)
             for name, lens in DECODE_CASES.items()}
    for name in DECODE_FILL:
        if cases[name]["working_blocks"] < sms:
            raise AssertionError(f"decode {name}: {cases[name]['working_blocks']} working "
                                 f"blocks on {sms} SMs")
    main = cases["check batch"]
    return {
        "name": "paged_decode_attention" + ("_int8" if int8 else ""), "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_attention.py:36",
        "shape": f"B={len(main['lens'])} lens={main['lens']} h={H} kvh={KVH} d={D} bs={BS} "
                 + ("int8 cache + f32 scales" if int8 else "bf16")
                 + "; top-level numbers: the check batch; every case under 'cases' "
                   "(library: SDPA over the gathered KV; unified_ms: the unified kernel "
                   "on the same rows as q_len = 1 rows)",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "unified_ms",
                                "bound_ms", "bound_by")},
        "cases": cases,
    }


def int8_context(torch, k):
    """A bf16 context [T, KVH, D] quantized per BS-row block, in the form
    ops.attention.gather_kv_quant hands the flash-extend kernel: int8 rows
    and f32 per-position scales [T, KVH]."""
    from dynamo_tpu_torch.ops.quant import quantize_blocks

    T = k.shape[0]
    q, s = quantize_blocks(k.reshape(T // BS, BS, *k.shape[1:]))
    return q.reshape(k.shape), s[:, None, :].expand(T // BS, BS, k.shape[1]).reshape(T, -1)


def check_flash(torch, gen, timer, int8=False):
    from dynamo_tpu_torch.ops import cuda_prefill

    def case(S, start, total):
        T = -(-total // BS) * BS
        q = torch.randn(S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(T, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(T, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
        if not int8:
            return (q, k, v, start, total), {}
        (kq, ks), (vq, vs) = int8_context(torch, k), int8_context(torch, v)
        return (q, kq, vq, start, total), {"k_scales": ks, "v_scales": vs}

    def run(c, kernel):
        fn = (cuda_prefill.flash_extend_attention if kernel
              else cuda_prefill.flash_extend_reference)
        return fn(*c[0], **c[1])

    tag = " int8" if int8 else ""
    # a ragged continuation chunk (952 real rows in a 1024 bucket over a
    # 2048-token prefix), checked only, then the full first chunk, timed
    cont = case(1024, 2048, 3000)
    err = compare(torch, run(cont, True), run(cont, False), "flash_extend continuation" + tag)
    S = 2048
    first = case(S, 0, S)
    err = max(err, compare(torch, run(first, True), run(first, False), "flash_extend" + tag))
    q, k, v, _, _ = first[0]
    if int8:   # the library call takes the dequantized context
        k = (k.float() * first[1]["k_scales"][..., None]).to(torch.bfloat16)
        v = (v.float() * first[1]["v_scales"][..., None]).to(torch.bfloat16)
    g = H // KVH
    ql = q.transpose(0, 1)[None].contiguous()
    kl = k.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    vl = v.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = S * (S + 1) // 2
    ctx_bytes = 2 * S * KVH * (D + 4) if int8 else 2 * 2 * S * KVH * D
    b, by = bound(2 * 2 * S * H * D + ctx_bytes, 4 * pairs * H * D)
    return {
        "name": "flash_extend_attention" + ("_int8" if int8 else ""), "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/flash_extend.cu",
        "replaces": "dynamo_tpu/ops/pallas_prefill.py:44",
        "shape": f"S={S} start=0 total={S} h={H} kvh={KVH} d={D} "
                 + ("int8 context + f32 per-position scales " if int8 else "bf16 ")
                 + "(also checked: S=1024 start=2048 total=3000)",
        "max_abs_err": err,
        "ms": timer(lambda: run(first, True)),
        "plain_ms": timer(lambda: run(first, False), reps=5),
        "library_ms": timer(lambda: sdpa(ql, kl, vl, is_causal=True)),
        "bound_ms": b, "bound_by": by,
    }


def check_unified(torch, gen, timer, int8=False):
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    # (q_len, seq_len): a 437-token prefill segment over a 1200-token
    # prefix, decode rows (one past 2,000 tokens), an empty row; 5-token
    # gaps between segments
    rows = [(437, 1637), (1, 2100), (1, 17), (0, 300), (1, 999), (1, 250), (1, 1)]
    kc, vc, tables = paged_case(torch, gen, [sl for _, sl in rows], num_blocks=512,
                                int8=int8)
    starts, pos = [], 0
    for ql, _ in rows:
        starts.append(pos)
        pos += ql + 5
    Tq = pos
    q = torch.randn(Tq, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    i32 = dict(dtype=torch.int32, device="cuda")
    q_starts = torch.tensor(starts, **i32)
    q_lens = torch.tensor([ql for ql, _ in rows], **i32)
    seq_lens = torch.tensor([sl for _, sl in rows], **i32)
    args = (q, kc, vc, tables, q_starts, q_lens, seq_lens)
    max_q = max(ql for ql, _ in rows)
    bounds = dict(max_q_len=max_q, max_seq_len=max(sl for _, sl in rows))
    err = compare(torch, cuda_unified.ragged_paged_attention(*args, **bounds),
                  att.ragged_paged_attention(*args), "unified int8" if int8 else "unified")
    # library yardstick: one masked SDPA over the rows padded to a batch
    R, T = len(rows), max(sl for _, sl in rows)
    qp = torch.zeros(R, H, max_q, D, dtype=torch.bfloat16, device="cuda")
    mask = torch.zeros(R, 1, max_q, T, dtype=torch.bool, device="cuda")
    kp = torch.zeros(R, H, T, D, dtype=torch.bfloat16, device="cuda")
    vp = torch.zeros_like(kp)
    for r, (ql, sl) in enumerate(rows):
        k_r, v_r = expand_kv(torch, kc, vc, tables[r], sl)
        kp[r, :, :sl], vp[r, :, :sl] = k_r, v_r
        qp[r, :, :ql] = q[starts[r]:starts[r] + ql].transpose(0, 1)
        qpos = torch.arange(sl - ql, sl, device="cuda")
        mask[r, 0, :ql] = torch.arange(T, device="cuda")[None, :] <= qpos[:, None]
        mask[r, 0, ql:, 0] = True   # padding rows: one visible key, no NaN
    sdpa = torch.nn.functional.scaled_dot_product_attention
    live = [(ql, sl) for ql, sl in rows if ql > 0 and sl > 0]
    pairs = sum(sum(sl - ql + i + 1 for i in range(ql)) for ql, sl in live)
    b, by = bound(
        2 * (sum(ql for ql, _ in live) * H * D          # member queries in
             + Tq * H * D)                              # packed output
        + sum(kv_bytes(sl, KVH, int8) for _, sl in live)   # K and V rows needed
        + 4 * (3 * R + sum(-(-sl // BS) for _, sl in live)),
        4 * pairs * H * D,
    )
    return {
        "name": "ragged_paged_attention" + ("_int8" if int8 else ""), "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "shape": f"rows(q_len,seq_len)={rows} Tq={Tq} h={H} kvh={KVH} d={D} bs={BS} "
                 + ("int8 cache + f32 scales" if int8 else "bf16"),
        "max_abs_err": err,
        "ms": timer(lambda: cuda_unified.ragged_paged_attention(*args, **bounds)),
        "plain_ms": timer(lambda: att.ragged_paged_attention(*args), reps=5),
        "library_ms": timer(lambda: sdpa(qp, kp, vp, attn_mask=mask)),
        "bound_ms": b, "bound_by": by,
    }


# Gemma attention shapes (gemma2-2b and gemma3-4b): 8 query heads over 4 kv
# heads, head_dim 256, block 16
GH, GKVH, GD = 8, 4, 256
# gemma3's sliding window; contexts up to ~5 windows long, so windowed rows
# skip pages
GEMMA_WINDOW = 1024
# (q_len, seq_len, window): windowed prefill segments over long prefixes,
# windowed decode rows several windows long and exactly w, w + 1 and w + bs
# long, full rows (window 0) and an empty row in one launch
GEMMA_ROWS = [(700, 3100, 1024), (1, 5000, 1024), (1, 1024, 1024), (1, 1025, 1024),
              (1, 1040, 1024), (0, 300, 1024), (1, 17, 1024), (1, 4100, 0),
              (300, 1200, 0), (1, 3000, 1024)]
GEMMA_SOFTCAP = 50.0
# the Gemma serving run's prompt lengths (serve_gemma)
GEMMA_PROMPTS = (300, 1500, 2600, 4100, 5200, 6000, 7000, 8000)
# a decode-only batch: those 8 rows at their 16th output token, through a
# gemma2 sliding layer (window 4096, softcap): each row fills G = 2 of the
# tile's 64 query rows
GEMMA_DECODE_ROWS = [(1, n + 16, 4096) for n in GEMMA_PROMPTS]
# short rows at the kernel's own split size (SPLIT_KEYS = 512): the two
# 32-token rows, one windowed and one full, end in a split of 7 and of 10
# keys that starts after the positions of their first 25 and 22 tokens
# (those see no key there: l = 0, which the merge must weigh 0); a
# windowed decode row with planted window edges in 3 splits, a 5-token
# full row in 2, and a windowed segment that fits one split; sinks on, so
# a sink counted once per split would show. No 512-key split of a row of
# at most 64 / G = 32 tokens can lie wholly below a token's window: every
# token's window starts inside the row's first split.
GEMMA_SPLIT_ROWS = [(32, 3015, 1000), (32, 1034, 0), (20, 2000, 100), (1, 2500, 1024),
                    (5, 700, 0)]
# each case one launch over its rows (default GEMMA_ROWS): which attributes
# it carries
GEMMA_CASES = {
    "window": dict(window=True),
    "full": dict(),
    "softcap": dict(softcap=True),
    "sinks": dict(sinks=True),
    "window+softcap+sinks": dict(window=True, softcap=True, sinks=True),
    "decode batch, window+softcap": dict(window=True, softcap=True, rows=GEMMA_DECODE_ROWS),
    "short rows, splits some tokens never reach, window+sinks": dict(
        window=True, sinks=True, rows=GEMMA_SPLIT_ROWS),
}


def visible_pairs(ql, sl, w):
    """(query, key) pairs a row's segment scores: token p = sl - ql + i sees
    keys max(p - w + 1, 0) .. p (w <= 0: from 0)."""
    n = 0
    for p in range(sl - ql, sl):
        n += p + 1 - (max(p - w + 1, 0) if w > 0 else 0)
    return n


def live_pages(ql, sl, w):
    """Pages of a row the kernel must read: from the first page the row's
    earliest query sees (ops/costs.py unified_attention_bytes) to
    ceil(seq_len / BS)."""
    first = max(sl - ql - w + 1, 0) // BS if w > 0 else 0
    return -(-sl // BS) - first


# planted keys at each windowed decode row's window edge (plant_window_edges)
EDGE_SCORE = 38.0
EDGE_V = (6.0, -3.0)


def plant_window_edges(torch, kc, vc, tables, q, starts, rows):
    """At each windowed decode row's window edge, whose query sits at
    p = seq_len - 1: a key at p - w (the last one the window drops) and
    one at p - w + 1 (the first it keeps), each the least-norm key whose
    scaled score is EDGE_SCORE for every one of its kv head's G queries
    (38 against ~16 at most for the random keys, and still the largest
    after a softcap of 50; the same for every head, so at G = 8 no head's
    query misses it), with values EDGE_V. Taking or dropping either moves
    every head's output by O(1), so a window bound one key off fails the
    kernel's compare. In place on a bf16 cache [nb, BS, kvh, d]. Returns
    (query token, whether key p - w exists) per planted row."""
    kvh, d = kc.shape[2], kc.shape[3]
    edges = []
    for r, (ql, sl, w) in enumerate(rows):
        if ql != 1 or w <= 0 or sl < w:   # no key at the window's edge
            continue
        tok = starts[r]
        qg = q[tok].float().reshape(kvh, -1, d)                      # [kvh, G, d]
        want = torch.full(qg.shape[:2] + (1,), EDGE_SCORE * d ** 0.5, device=q.device)
        k = (qg.transpose(1, 2) @ torch.linalg.solve(qg @ qg.transpose(1, 2), want))[..., 0]
        for j, val in zip((sl - 1 - w, sl - w), EDGE_V):
            if j >= 0:
                page, off = int(tables[r, j // BS]), j % BS
                kc[page, off] = k.to(kc.dtype)
                vc[page, off] = val
        edges.append((tok, sl - 1 - w >= 0))
    return edges


def edge_gap(torch, args, kw, want, edges) -> float:
    """Least relative L2 distance, over the planted tokens' (token, head)
    rows, between ``want`` (the plain output at the rows' windows) and the
    plain output at windows one key narrower, and one key wider where a
    key below the bound exists: what a one-key error at the edge costs."""
    from dynamo_tpu_torch.ops import attention as att

    gaps = []
    for step in (-1, 1):
        other = att.ragged_paged_attention(
            *args, **dict(kw, windows=kw["windows"] + step)).float()
        for tok, below in edges:
            if step > 0 and not below:
                continue
            a = want[tok].float()
            gaps.append(((a - other[tok]).norm(dim=-1) / a.norm(dim=-1)).min().item())
    return min(gaps)


def attrs_library_call(torch, q, kc, vc, tables, starts, rows, windowed, softcap, sinks,
                       flex):
    """One PyTorch call computing the same function as an attribute case
    (check_unified_attrs), on the same KV gathered (an int8 cache
    dequantized) into a padded batch [R, h, Tp, d] whose key T (one past
    the longest row) is zero and whose length Tp is a multiple of 16 (an
    unaligned mask would be copied on every call); padding query rows see
    key 0.
    Without ``flex``: scaled_dot_product_attention with the boolean causal
    (and window) mask; with sinks, the same call with a float mask whose
    entry at the zero key is the head's sink logit, so the sink enters the
    denominator only. With ``flex`` (compiled flex_attention; the softcap
    cases, and gpt-oss's sink cases): a score_mod taking cap * tanh(s /
    cap) where a softcap is on and returning the sink at the zero key,
    under a block mask of the same visibility. Returns (call, packed output
    of a call's result)."""
    from torch.nn.attention.flex_attention import create_block_mask

    dev = q.device
    R, T = len(rows), max(sl for _, sl, _ in rows)
    max_q = max(ql for ql, _, _ in rows)
    h, d = q.shape[1], q.shape[2]
    Tp = -(-(T + 1) // 16) * 16
    qp = torch.zeros(R, h, max_q, d, dtype=torch.bfloat16, device=dev)
    kp = torch.zeros(R, h, Tp, d, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros_like(kp)
    for r, (ql, sl, _) in enumerate(rows):
        kp[r, :, :sl], vp[r, :, :sl] = expand_kv(torch, kc, vc, tables[r], sl, h=h)
        qp[r, :, :ql] = q[starts[r]:starts[r] + ql].transpose(0, 1)
    i64 = dict(dtype=torch.long, device=dev)
    q_len = torch.tensor([ql for ql, _, _ in rows], **i64)
    q_off = torch.tensor([sl - ql for ql, sl, _ in rows], **i64)
    # no window: a bound past every key
    lo = torch.tensor([w if windowed and w > 0 else Tp for _, _, w in rows], **i64)

    def visible(b, q_idx, kv_idx):
        p = q_off[b] + q_idx
        vis = (kv_idx <= p) & (kv_idx > p - lo[b])
        return torch.where(q_idx >= q_len[b], kv_idx == 0, vis)

    def unpack(out):
        packed = torch.zeros_like(q)
        for r, (ql, _, _) in enumerate(rows):
            packed[starts[r]:starts[r] + ql] = out[r, :, :ql].transpose(0, 1)
        return packed

    sdpa = torch.nn.functional.scaled_dot_product_attention
    if flex is None:
        b, qi, ki = (torch.arange(n, device=dev) for n in (R, max_q, Tp))
        vis = visible(b[:, None, None], qi[None, :, None], ki[None, None, :])[:, None]
        if sinks is None:
            return (lambda: sdpa(qp, kp, vp, attn_mask=vis)), unpack
        mask = torch.zeros(R, h, max_q, Tp, dtype=torch.bfloat16, device=dev)
        mask.masked_fill_(~vis, float("-inf"))
        mask[..., T] = sinks[None, :, None].to(torch.bfloat16)
        return (lambda: sdpa(qp, kp, vp, attn_mask=mask)), unpack

    def mask_mod(b, hh, q_idx, kv_idx):
        vis = visible(b, q_idx, kv_idx)
        return vis | (kv_idx == T) if sinks is not None else vis

    def score_mod(score, b, hh, q_idx, kv_idx):
        capped = softcap * torch.tanh(score / softcap) if softcap else score
        return capped if sinks is None else torch.where(kv_idx == T, sinks[hh], capped)

    block_mask = create_block_mask(mask_mod, R, None, max_q, Tp, device=dev)
    return (lambda: flex(qp, kp, vp, score_mod=score_mod, block_mask=block_mask)), unpack


# gpt-oss-20b attention shapes: 64 query heads over 8 kv heads (G = 8, so a
# q tile holds 8 tokens), head_dim 64, block 16, window 128 on even layers
# and per-head sinks on all
OH, OKVH, OD = 64, 8, 64
GPTOSS_WINDOW = 128
# the gpt-oss serving run's prompt lengths (serve_windowed)
GPTOSS_PROMPTS = (100, 700, 1500, 2600, 3300, 4100, 5000, 6000)
GPTOSS_INT8_PROMPTS = (4100, 1500, 300)
# a decode batch of 8 rows of 1 to 8000 keys, through a sliding layer
# (window 128) and through a full one (window 0), sinks on in both
GPTOSS_DECODE_LENS = (1, 130, 700, 1500, 3000, 4500, 6000, 8000)
GPTOSS_DECODE_ROWS = [(1, n, GPTOSS_WINDOW) for n in GPTOSS_DECODE_LENS]
# the last 2048-token chunk of a 6000-token prompt through a sliding layer
GPTOSS_PREFILL_ROWS = [(2048, 6000, GPTOSS_WINDOW)]
# a mixed step: windowed and full prefill segments, decode rows at and
# past the window, an empty row
GPTOSS_MIXED_ROWS = [(300, 1200, GPTOSS_WINDOW), (1, 3000, GPTOSS_WINDOW),
                     (1, 129, GPTOSS_WINDOW), (0, 50, GPTOSS_WINDOW), (1, 4100, 0),
                     (40, 2000, 0), (1, 17, GPTOSS_WINDOW)]
GPTOSS_CASES = {
    "decode batch, window 128 + sinks": dict(window=True, sinks=True, rows=GPTOSS_DECODE_ROWS),
    "decode batch, full + sinks": dict(sinks=True, rows=GPTOSS_DECODE_ROWS),
    "prefill 2048 of 6000, window 128 + sinks": dict(window=True, sinks=True,
                                                     rows=GPTOSS_PREFILL_ROWS),
    "mixed rows, windows + sinks": dict(window=True, sinks=True),
}


@dataclasses.dataclass(frozen=True)
class AttrFamily:
    """One model family's shapes and cases for the unified kernel's
    attribute checks (check_unified_attrs, check_merge)."""
    name: str          # report names end in _<name>
    h: int
    kvh: int
    d: int
    rows: list         # a case's rows (q_len, seq_len, window) unless it names its own
    cases: dict        # case -> its attributes (window, softcap, sinks, rows)
    main: str          # the case of the top-level numbers
    decode: str        # the decode batch: at least one working block per SM
    merge_rows: list   # the decode rows whose partial states check the merge
    merge_name: str
    softcap: float = 0.0
    split_rows: list = None   # rows whose splits some tokens never reach
    flex_for_sinks: bool = False   # library: flex_attention for sinks too
    # queries N(0, q_scale^2), sinks N(sink_mean, sink_std^2)
    q_scale: float = 4.0
    sink_mean: float = 10.0
    sink_std: float = 2.0


GEMMA = AttrFamily("gemma", GH, GKVH, GD, GEMMA_ROWS, GEMMA_CASES, "window",
                   "decode batch, window+softcap", GEMMA_DECODE_ROWS,
                   "merge_attention_partials", softcap=GEMMA_SOFTCAP,
                   split_rows=GEMMA_SPLIT_ROWS)
# (a window-128 decode row reads at most 128 keys and is never split: the
# full layer's decode batch fills the card and feeds the merge). No
# softcap, so the queries keep the model's score scale (N(0, 1) at d 64),
# and the sinks N(5, 1) weigh like a window's 128 keys (~e^5.3 of mass)
GPTOSS = AttrFamily("gptoss", OH, OKVH, OD, GPTOSS_MIXED_ROWS, GPTOSS_CASES,
                    "decode batch, window 128 + sinks", "decode batch, full + sinks",
                    [(1, n, 0) for n in GPTOSS_DECODE_LENS], "merge_attention_partials_gptoss",
                    flex_for_sinks=True, q_scale=1.0, sink_mean=5.0, sink_std=1.0)


def check_unified_attrs(torch, gen, timer, fam: AttrFamily, int8=False, flex=None):
    """The unified kernel with its row attributes at ``fam``'s shapes, one
    launch per case over its rows, each against its plain version, timed
    with its bound and its library yardstick (attrs_library_call; ``flex``:
    the compiled flex_attention it uses).
    Queries are N(0, fam.q_scale^2): Gemma's x4 brings scores to a
    softcap's range (~N(0, 16)), gpt-oss keeps N(0, 1); sinks are
    N(fam.sink_mean, fam.sink_std^2) logits, so their mass counts against
    rows' largest scores. Each windowed decode row carries planted keys at
    its window's edge (plant_window_edges); each windowed case asserts that
    a one-key error there costs at least 10 x KERNEL_ROW_REL."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    i32 = dict(dtype=torch.int32, device="cuda")
    h, kvh, d = fam.h, fam.kvh, fam.d
    sinks = fam.sink_mean + fam.sink_std * torch.randn(h, generator=gen, device="cuda")
    made = {}

    def inputs(rows):
        """Random paged K/V with planted window edges and packed queries
        for ``rows`` (segments 5 padding tokens apart), made once per row
        set."""
        key = id(rows)
        if key not in made:
            pages = sum(-(-sl // BS) for _, sl, _ in rows)
            kc, vc, tables = paged_case(torch, gen, [sl for _, sl, _ in rows],
                                        num_blocks=pages + 64, kvh=kvh, d=d)
            starts, pos = [], 0
            for ql, _, _ in rows:
                starts.append(pos)
                pos += ql + 5
            q = (fam.q_scale * torch.randn(pos, h, d, generator=gen,
                                           device="cuda")).to(torch.bfloat16)
            edges = plant_window_edges(torch, kc, vc, tables, q, starts, rows)
            if int8:
                kc, vc = quantized(torch, kc), quantized(torch, vc)
            made[key] = (starts, pos, edges, (
                q, kc, vc, tables, torch.tensor(starts, **i32),
                torch.tensor([ql for ql, _, _ in rows], **i32),
                torch.tensor([sl for _, sl, _ in rows], **i32)),
                torch.tensor([w for _, _, w in rows], **i32))
        return made[key]

    tag = f" {fam.name}" + (" int8" if int8 else "")
    cases, worst = {}, 0.0
    for name, attrs in fam.cases.items():
        rows = attrs.get("rows", fam.rows)
        starts, Tq, edges, args, windows = inputs(rows)
        q, kc, vc, tables = args[:4]
        max_q = max(ql for ql, _, _ in rows)
        R = len(rows)
        live = [(ql, sl, w) for ql, sl, w in rows if ql > 0 and sl > 0]
        kw = {}
        if attrs.get("window"):
            kw["windows"] = windows
        if attrs.get("softcap"):
            kw["softcap"] = fam.softcap
        if attrs.get("sinks"):
            kw["sinks"] = sinks
        plain = att.ragged_paged_attention(*args, **kw)
        bounds = dict(max_q_len=max_q, max_seq_len=max(sl for _, sl, _ in rows))
        # the launch logs its grid and the split count per row that the
        # kernel itself wrote; those must follow the plain split plan
        cuda_unified.split_log = []
        try:
            got = cuda_unified.ragged_paged_attention(*args, **bounds, **kw)
            (grid, n_dev), = cuda_unified.split_log
        finally:
            cuda_unified.split_log = None
        err = compare(torch, got, plain, f"unified{tag} {name}")
        worst = max(worst, err)
        n_kernel = n_dev.tolist() if n_dev is not None else [0] * R
        S, QS = cuda_unified.split_shape(h, kvh, max_q, bounds["max_seq_len"])
        n_plain = [att.split_plan(ql, sl, w if "windows" in kw else 0,
                                  cuda_unified.SPLIT_KEYS, cuda_unified.KEY_STEP, S)[2]
                   if S > 1 and 0 < ql <= QS and sl > 0 else 0 for ql, sl, w in rows]
        if n_kernel != n_plain:
            raise AssertionError(f"unified{tag} {name}: the kernel split its rows "
                                 f"{n_kernel}, the plain split plan {n_plain}")
        tq = att.TILE_ROWS // (h // kvh)
        blocks = kvh * sum(n if n >= 2 else -(-ql // tq) for (ql, sl, _), n
                           in zip(rows, n_kernel) if ql > 0 and sl > 0)
        unreached = None
        if rows is fam.split_rows:
            # (row, split, token) triples where the token sees none of the
            # split's keys (l = 0 for every head), from the plain partials
            _, _, l, n = att.attention_partials(
                *args, split_keys=cuda_unified.SPLIT_KEYS, align=cuda_unified.KEY_STEP,
                windows=kw.get("windows"), max_splits=S)
            unreached = sum(int((l[r, :c, :ql] == 0).all(-1).sum())
                            for r, (c, (ql, _, _)) in enumerate(zip(n.tolist(), rows)) if c)
            if not unreached:
                raise AssertionError(f"unified{tag} {name}: no token misses a whole split")
            log(f"  unified{tag} {name}: {unreached} (row, split, token) triples "
                "whose split holds no key the token sees")
        gap = None
        if "windows" in kw and edges:
            gap = edge_gap(torch, args, kw, plain, edges)
            if gap < 10 * KERNEL_ROW_REL:
                raise AssertionError(f"unified{tag} {name}: a one-key window error moves "
                                     f"the planted rows by only {gap:.3g}")
        wins = [w if attrs.get("window") else 0 for _, _, w in live]
        pairs = sum(visible_pairs(ql, sl, w) for (ql, sl, _), w in zip(live, wins))
        pages = sum(live_pages(ql, sl, w) for (ql, sl, _), w in zip(live, wins))
        kv_moved = (2 * pages * BS * kvh * d * (1 if int8 else 2)
                    + (2 * 4 * pages * kvh if int8 else 0))
        b, by = bound(
            2 * (sum(ql for ql, _, _ in live) * h * d + Tq * h * d)   # queries in, out
            + kv_moved + 4 * (4 * R + pages) + (4 * h if "sinks" in kw else 0),
            4 * pairs * h * d,
        )
        use_flex = bool(kw.get("softcap")) or (fam.flex_for_sinks and "sinks" in kw)
        library, unpack = attrs_library_call(
            torch, q, kc, vc, tables, starts, rows, "windows" in kw, kw.get("softcap"),
            kw.get("sinks"), flex if use_flex else None)
        lib_err = (unpack(library()).float() - plain.float()).abs().max().item()
        cases[name] = {
            "rows": rows, "max_abs_err": err, "window_edge_gap": gap,
            "grid": grid, "splits_per_row": n_kernel, "working_blocks": blocks,
            "tokens_missing_a_split": unreached,
            "ms": timer(lambda: cuda_unified.ragged_paged_attention(*args, **bounds, **kw)),
            "plain_ms": timer(lambda: att.ragged_paged_attention(*args, **kw), reps=5),
            "library_ms": timer(library), "library": "flex_attention (compiled)"
            if use_flex else "scaled_dot_product_attention",
            "library_max_abs_err": lib_err, "bound_ms": b, "bound_by": by,
        }
        del library, unpack
        log(f"  unified{tag} {name}: max abs err {err:.3g}"
            + (f", window-edge gap {gap:.3g}" if gap is not None else "")
            + f"; {cases[name]['ms']:.4f} ms kernel, {cases[name]['plain_ms']:.4f} ms plain, "
            f"{cases[name]['library_ms']:.4f} ms library ({cases[name]['library']}, max abs "
            f"err {lib_err:.3g}), bound {b:.4f} ms ({by}); grid {grid}, splits per row "
            f"{n_kernel} (the kernel's count), {blocks} working blocks")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    decode = cases[fam.decode]
    if decode["working_blocks"] < sms:
        raise AssertionError(f"the {fam.name} decode batch runs {decode['working_blocks']} "
                             f"working blocks on {sms} SMs")
    main = cases[fam.main]
    return {
        "name": f"ragged_paged_attention_{fam.name}" + ("_int8" if int8 else ""),
        "route": "cuda", "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "shape": f"rows(q_len,seq_len,window)={main['rows']} h={h} kvh={kvh} d={d} "
                 f"bs={BS} " + ("int8 cache + f32 scales" if int8 else "bf16")
                 + f"; top-level numbers: the {fam.main!r} case; every case under "
                   "'cases' (library: SDPA with the window mask, with the sinks as a "
                   "float mask over a zero key; compiled flex_attention where a "
                   "softcap is on" + (" or sinks are" if fam.flex_for_sinks else "") + ")",
        "max_abs_err": worst, "ms": main["ms"], "plain_ms": main["plain_ms"],
        "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "cases": cases,
    }


def check_merge(torch, gen, timer, fam: AttrFamily):
    """The split-K merge kernel against its plain version on partial states
    shaped as ``fam``'s decode batch leaves them (its merge_rows through
    the split plan; the Gemma batch: 8 rows, up to 16 splits of one token,
    8 heads, d 256). Each head's split maxima m lie near one level
    (c_h + N(0, 1)), each split's sum l in [1, 9] (at least 1: the split's
    own largest key), every split row's second split is empty (l = 0,
    m = NEG_INF), and the sinks sit near the rows' largest m
    (c_h + 1.5 + N(0, 1)) so that their mass counts: the plain merge with
    the sink counted once per split (a mutant) must fail the compare
    against the kernel."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    rows, h, d = fam.merge_rows, fam.h, fam.d
    R, dev = len(rows), "cuda"
    S, QS = cuda_unified.split_shape(h, fam.kvh, 1, max(sl for _, sl, _ in rows))
    n = [att.split_plan(ql, sl, w, cuda_unified.SPLIT_KEYS, cuda_unified.KEY_STEP, S)[2]
         for ql, sl, w in rows]
    level = 4 * torch.randn(h, generator=gen, device=dev)
    m = level + torch.randn(R, S, QS, h, generator=gen, device=dev)
    l = 1 + 8 * torch.rand(R, S, QS, h, generator=gen, device=dev)
    acc = torch.randn(R, S, QS, h, d, generator=gen, device=dev) * l[..., None]
    l[:, 1], m[:, 1], acc[:, 1] = 0.0, att.NEG_INF, 0.0
    i32 = dict(dtype=torch.int32, device=dev)
    meta = (torch.tensor(n, **i32), torch.arange(R, **i32), torch.ones(R, **i32))
    args = (acc, m, l, *meta)
    sinks = level + 1.5 + torch.randn(h, generator=gen, device=dev)
    out = torch.zeros(R, h, d, dtype=torch.bfloat16, device=dev)
    got = cuda_unified.merge_attention_partials(*args, out.clone(), sinks)
    err = compare(torch, got, att.merge_attention_partials(*args, out.clone(), sinks),
                  fam.merge_name)
    # the mutant: every live split seeded with the sink (l_s + exp(sink - m_s))
    per_split = torch.where(l > 0, l + torch.exp(sinks - m), l)
    wrong = att.merge_attention_partials(acc, m, per_split, *meta, out.clone())
    split = [r for r, c in enumerate(n) if c >= 2]
    moved = ((wrong[split].float() - got[split].float()).norm(dim=-1)
             / got[split].float().norm(dim=-1))
    gap = [moved.min().item(), moved.max().item()]
    try:
        compare(torch, got, wrong, f"{fam.merge_name} against its sink-per-split mutant")
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{fam.merge_name}: a sink counted once per split passes the "
                             "compare")
    # bytes: m and l of every split of a split row, the accumulator of the
    # splits that saw a key (the kernel skips the rest), the output rows,
    # the row metadata and the sinks
    live = sum(int((l[r, :n[r]] > 0).sum()) for r in split)
    b, by = bound(sum(n[r] for r in split) * QS * h * 8 + live * d * 4
                  + len(split) * QS * h * d * 2 + 4 * 3 * R + 4 * h, 0)
    return {
        "name": fam.merge_name, "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "serves": "split-K of the unified kernel (kernel 3): merges its partial states",
        "shape": f"partials of the {fam.name} decode rows {rows}: R={R} S={S} QS={QS} h={h} "
                 f"d={d}, splits per row {n}, sinks on, one empty split per split row",
        "max_abs_err": err, "sink_per_split_row_gap": gap,
        "ms": timer(lambda: cuda_unified.merge_attention_partials(*args, out, sinks)),
        "plain_ms": timer(lambda: att.merge_attention_partials(*args, out, sinks), reps=5),
        "library_ms": None, "bound_ms": b, "bound_by": by,
    }


def check_group_sizes(torch, gen) -> float:
    """The other query-heads-per-kv-head counts the kernels take (1, 2 and
    8: e.g. qwen3-0.6b has 2, llama3-70b 8), each kernel against its plain
    version on small ragged cases; untimed."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified

    kvh, worst = 2, 0.0
    i32 = dict(dtype=torch.int32, device="cuda")
    for g, int8 in ((1, False), (2, False), (8, False), (1, True), (2, True), (8, True)):
        h = kvh * g
        lens = [1, 40, 333]
        kc, vc, tables = paged_case(torch, gen, lens, num_blocks=64, kvh=kvh, int8=int8)
        tag = f"G={g}" + (" int8" if int8 else "")
        q = torch.randn(len(lens), h, D, generator=gen, device="cuda").to(torch.bfloat16)
        args = (q, kc, vc, tables, torch.tensor(lens, **i32))
        worst = max(worst, compare(torch, cuda_attention.paged_decode_attention(*args),
                                   att.paged_decode_attention(*args), f"decode {tag}"))
        qf = torch.randn(77, h, D, generator=gen, device="cuda").to(torch.bfloat16)
        kf = torch.randn(160, kvh, D, generator=gen, device="cuda").to(torch.bfloat16)
        vf = torch.randn(160, kvh, D, generator=gen, device="cuda").to(torch.bfloat16)
        scales = {}
        if int8:
            (kf, ks), (vf, vs) = int8_context(torch, kf), int8_context(torch, vf)
            scales = {"k_scales": ks, "v_scales": vs}
        fargs = (qf, kf, vf, 70, 147)
        worst = max(worst, compare(torch, cuda_prefill.flash_extend_attention(*fargs, **scales),
                                   cuda_prefill.flash_extend_reference(*fargs, **scales),
                                   f"flash_extend {tag}"))
        qu = torch.randn(50, h, D, generator=gen, device="cuda").to(torch.bfloat16)
        uargs = (qu, kc, vc, tables, torch.tensor([0, 40, 45], **i32),
                 torch.tensor([1, 3, 5], **i32), torch.tensor(lens, **i32))
        worst = max(worst, compare(torch, cuda_unified.ragged_paged_attention(*uargs),
                                   att.ragged_paged_attention(*uargs), f"unified {tag}"))
    return worst


# block-copy checks: a Llama-3-8B layer cache of this many pages, moved M
# pages at a time for each M (random distinct ids); the last M is timed
COPY_PAGES = 2048
COPY_MS = (1, 37, 256)


def check_block_copy(torch, gen, timer):
    """gather / scatter / copy against their plain versions, BIT-exact, on
    a [2048, 16, 8, 128] bf16 layer cache and on its int8 pair (payload +
    [2048, 8] f32 scales, each alone and as the pair wrappers move them) at
    M = 1, 37 and 256. Times (M = 256) are taken on the int8 pair, which
    the pair wrappers move in ONE launch (asserted); the bf16 page times
    ride along under ``bf16_ms``."""
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    dev = "cuda"
    bf16 = torch.randn(COPY_PAGES, BS, KVH, D, generator=gen, device=dev).to(torch.bfloat16)
    pair = quantized(torch, bf16)
    rng = np.random.default_rng(5)

    def ids(*arrays, device=dev):
        return [torch.as_tensor(a.astype(np.int32), device=device) for a in arrays]

    def exact(got, want, name):
        if got.dtype != want.dtype or got.shape != want.shape or not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel result is not bit-equal to its plain version")

    def parts(cache):
        return [cache] if isinstance(cache, torch.Tensor) else [cache.data, cache.scale]

    for M in COPY_MS:
        perm = rng.permutation(COPY_PAGES)
        # copy_blocks checks src/dst disjointness on the host: CPU ids
        (take,), (src, dst) = ids(perm[:M]), ids(perm[M:2 * M], perm[2 * M:3 * M], device="cpu")
        for label, cache in (("bf16", bf16), ("int8 payload+scales", pair)):
            for c in parts(cache):
                tag = f"M={M} {label} {tuple(c.shape)}"
                exact(bc.gather_blocks(c, take), bc.gather_blocks_ref(c, take), "gather " + tag)
                blocks = torch.randn(M, *c.shape[1:], generator=gen, device=dev).to(c.dtype)
                exact(bc.scatter_blocks(c.clone(), take, blocks),
                      bc.scatter_blocks_ref(c.clone(), take, blocks), "scatter " + tag)
                exact(bc.copy_blocks(c.clone(), src, dst),
                      bc.copy_blocks_ref(c.clone(), src, dst), "copy " + tag)
        tag = f"M={M} int8 pair"
        got = bc.gather_blocks_quant(pair, take)
        exact(got.data, bc.gather_blocks_ref(pair.data, take), "gather_blocks_quant " + tag)
        exact(got.scale, bc.gather_blocks_ref(pair.scale, take), "gather_blocks_quant " + tag)
        blocks = QuantizedKV(torch.randint(-127, 128, got.data.shape, generator=gen, device=dev,
                                           dtype=torch.int8),
                             torch.rand(got.scale.shape, generator=gen, device=dev))
        work = QuantizedKV(pair.data.clone(), pair.scale.clone())
        bc.scatter_blocks_quant(work, take, blocks)
        exact(work.data, bc.scatter_blocks_ref(pair.data.clone(), take, blocks.data),
              "scatter_blocks_quant " + tag)
        exact(work.scale, bc.scatter_blocks_ref(pair.scale.clone(), take, blocks.scale),
              "scatter_blocks_quant " + tag)
    M = COPY_MS[-1]
    perm = rng.permutation(COPY_PAGES)
    (take,), (src, dst) = ids(perm[:M]), ids(perm[M:2 * M], perm[2 * M:3 * M], device="cpu")
    before = (bc.GATHER.launches, bc.SCATTER.launches)
    pages = bc.gather_blocks_quant(pair, take)
    bc.scatter_blocks_quant(QuantizedKV(pair.data.clone(), pair.scale.clone()), take, pages)
    if (bc.GATHER.launches - before[0], bc.SCATTER.launches - before[1]) != (1, 1):
        raise AssertionError("the int8 pair's gather and scatter must be one launch each")
    bf16_pages = bc.gather_blocks(bf16, take)
    # each page read once and written once (int8 pages + their scale rows),
    # the int32 ids read once per array (copy reads two id lists)
    moved = 2 * M * (BS * KVH * D + 4 * KVH)
    b, by = bound(moved + 2 * 4 * M, 0)
    b_copy, _ = bound(moved + 2 * 2 * 4 * M, 0)
    common = {"route": "cuda", "source": "dynamo_tpu_torch/csrc/block_copy.cu",
              "bound_ms": b, "bound_by": by, "max_abs_err": 0.0,
              "shape": f"M={M} of {COPY_PAGES} pages: int8 [{BS},{KVH},{D}] + f32 [{KVH}] "
                       f"(payload and scales in one launch); also bit-checked at "
                       f"M={list(COPY_MS)} on bf16 pages and on the int8 pair"}

    # copy_blocks checks src/dst disjointness on the host and uploads the
    # ids before it launches: keep the GPU busy long enough to cover that
    slow_host = 2_000_000

    def copy_pair(c):
        bc.copy_blocks(c.data, src, dst)
        bc.copy_blocks(c.scale, src, dst)

    def copy_ref(c):
        bc.copy_blocks_ref(c.data, src, dst)
        bc.copy_blocks_ref(c.scale, src, dst)

    work = QuantizedKV(pair.data.clone(), pair.scale.clone())
    # PyTorch's index ops take int64 ids
    take_l, src_l, dst_l = take.long(), src.to(dev).long(), dst.to(dev).long()
    return [
        dict(common, name="gather_blocks", replaces="dynamo_tpu/ops/block_copy.py:30",
             ms=timer(lambda: bc.gather_blocks_quant(pair, take)),
             plain_ms=timer(lambda: (bc.gather_blocks_ref(pair.data, take),
                                     bc.gather_blocks_ref(pair.scale, take))),
             library_ms=timer(lambda: (torch.index_select(pair.data, 0, take_l),
                                       torch.index_select(pair.scale, 0, take_l))),
             library="torch.index_select (payload, scales)",
             bf16_ms=timer(lambda: bc.gather_blocks(bf16, take))),
        dict(common, name="scatter_blocks", replaces="dynamo_tpu/ops/block_copy.py:65",
             ms=timer(lambda: bc.scatter_blocks_quant(work, take, pages)),
             plain_ms=timer(lambda: (bc.scatter_blocks_ref(work.data, take, pages.data),
                                     bc.scatter_blocks_ref(work.scale, take, pages.scale))),
             library_ms=timer(lambda: (work.data.index_copy_(0, take_l, pages.data),
                                       work.scale.index_copy_(0, take_l, pages.scale))),
             library="Tensor.index_copy_ (payload, scales)",
             bf16_ms=timer(lambda: bc.scatter_blocks(bf16, take, bf16_pages))),
        dict(common, name="copy_blocks", replaces="dynamo_tpu/ops/block_copy.py:110",
             bound_ms=b_copy,
             ms=timer(lambda: copy_pair(work), busy=slow_host),
             plain_ms=timer(lambda: copy_ref(work), busy=slow_host),
             library_ms=timer(lambda: (
                 work.data.index_copy_(0, dst_l, work.data.index_select(0, src_l)),
                 work.scale.index_copy_(0, dst_l, work.scale.index_select(0, src_l)))),
             library="Tensor.index_copy_ of index_select (payload, scales)",
             bf16_ms=timer(lambda: bc.copy_blocks(bf16, src, dst), busy=slow_host)),
    ]


# layer-batched page moves: 32 Llama-3-8B layer caches of the int8 + KVBM
# serving run's device pool, moved LAYER_MS pages at a time
LAYER_PAGES = 512
LAYER_MS = (8, 256)


def check_layer_moves(torch, gen, timer):
    """gather_layers / scatter_layers (every layer's K and V pages, and the
    int8 scale rows, in ONE launch, in the [n, L, 2, ...] host layout)
    against their plain versions, BIT-exact, on 32 Llama-3-8B layer caches
    of LAYER_PAGES pages, bf16 and the int8 pair, at each LAYER_MS;
    timed at each M with their byte bound. One launch per call is
    asserted. No single PyTorch call does the same move: library_ms null."""
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    dev, L = "cuda", 32
    rng = np.random.default_rng(9)
    bf16 = [[torch.randn(LAYER_PAGES, BS, KVH, D, generator=gen, device=dev).to(torch.bfloat16)
             for _ in range(L)] for _ in range(2)]
    int8 = [[quantized(torch, c) for c in kv] for kv in bf16]

    def exact(got, want, name):
        for g, w in (zip([got.data, got.scale], [want.data, want.scale])
                     if isinstance(got, QuantizedKV) else [(got, want)]):
            if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel result is not bit-equal to its plain "
                                     "version")

    def clone(caches):
        return [c.clone() if isinstance(c, torch.Tensor)
                else QuantizedKV(c.data.clone(), c.scale.clone()) for c in caches]

    out = {}
    for label, (kcs, vcs) in (("bf16", bf16), ("int8 pair", int8)):
        for M in LAYER_MS:
            ids = torch.as_tensor(rng.permutation(LAYER_PAGES)[:M].astype(np.int32), device=dev)
            tag = f"M={M} {label}, {L} layers"
            launches = (bc.GATHER.launches, bc.SCATTER.launches)
            got = bc.gather_layers(kcs, vcs, ids)
            exact(got, bc.gather_layers_ref(kcs, vcs, ids), "gather_layers " + tag)
            # scatter pages other than the gathered ones' own, into clones
            pages = bc.gather_layers_ref(kcs, vcs, ids.flip(0))
            k2, v2, k3, v3 = clone(kcs), clone(vcs), clone(kcs), clone(vcs)
            bc.scatter_layers(k2, v2, ids, pages)
            bc.scatter_layers_ref(k3, v3, ids, pages)
            for a, b in zip(k2 + v2, k3 + v3):
                exact(a, b, "scatter_layers " + tag)
            del k2, v2, k3, v3
            if (bc.GATHER.launches - launches[0],
                    bc.SCATTER.launches - launches[1]) != (1, 1):
                raise AssertionError(f"{tag}: gather_layers / scatter_layers must be one "
                                     "launch each")
            page = BS * KVH * D * (1 if label == "int8 pair" else 2)
            page += 4 * KVH if label == "int8 pair" else 0
            b, by = bound(2 * M * L * 2 * page + 4 * M, 0)
            for name, fn, ref in (
                    ("gather_layers", lambda: bc.gather_layers(kcs, vcs, ids),
                     lambda: bc.gather_layers_ref(kcs, vcs, ids)),
                    ("scatter_layers", lambda: bc.scatter_layers(kcs, vcs, ids, got),
                     lambda: bc.scatter_layers_ref(kcs, vcs, ids, got))):
                r = out.setdefault((name, label), {"cases": {}})
                # (the busy wait covers the host's work before the launch)
                r["cases"][M] = {"ms": timer(fn, busy=2_000_000),
                                 "plain_ms": timer(ref, reps=5, busy=2_000_000),
                                 "bound_ms": b, "bound_by": by}
                c = r["cases"][M]
                log(f"  {name} {tag}: bit-exact, one launch; {c['ms']:.4f} ms kernel, "
                    f"{c['plain_ms']:.4f} ms plain, bound {b:.4f} ms ({by}), "
                    f"{b / c['ms'] * HBM_BYTES_S / 1e12:.2f} TB/s")
    results = []
    for name, line in (("gather_layers", 30), ("scatter_layers", 65)):
        main = out[(name, "int8 pair")]["cases"][LAYER_MS[-1]]
        results.append({
            "name": name, "route": "cuda", "source": "dynamo_tpu_torch/csrc/block_copy.cu",
            "replaces": f"dynamo_tpu/ops/block_copy.py:{line}",
            "shape": f"{L} layers x K/V of [{LAYER_PAGES}, {BS}, {KVH}, {D}]; top-level: the "
                     f"int8 pair (payload + f32 [{KVH}] scales) at M={LAYER_MS[-1]}, one "
                     "launch; every (form, M) under 'cases'",
            "max_abs_err": 0.0, "library_ms": None,
            "library": "none (no single PyTorch call moves every layer's pages)",
            **main,
            "cases": {f"{label} M={M}": c for (n, label), r in out.items() if n == name
                      for M, c in r["cases"].items()},
        })
    return results


def time_kv_writes(torch, gen, timer) -> dict:
    """One layer's decode KV write (ops.attention.write_decode_kv, plain
    PyTorch, no kernel of its own) for a batch of 8 rows on a Llama-3-8B
    layer cache, bf16 against int8 (the int8 write re-quantizes each row's
    whole block): a layer cost the int8 decode step pays 32 times."""
    from dynamo_tpu_torch.ops import attention as att

    B, nb = 8, 512
    kc, vc, _ = paged_case(torch, gen, [1], num_blocks=nb)
    qk, qv = quantized(torch, kc), quantized(torch, vc)
    k = torch.randn(B, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
    v = torch.randn(B, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
    blocks = torch.arange(1, B + 1, device="cuda") * 7
    offs = torch.arange(B, device="cuda") % BS + 1
    return {"bf16_ms": timer(lambda: att.write_decode_kv(kc, vc, k, v, blocks, offs)),
            "int8_ms": timer(lambda: att.write_decode_kv(qk, qv, k, v, blocks, offs))}


# ------------------------------------------------------------- phase 3
def attention_paths(torch, table, int8=False):
    """The model check's attention paths by name, each a (prefill, decode,
    ragged) triple of ``(q, k_cache, v_cache, total_len) -> out`` on one
    sequence whose pages are ``table``: the kernels, the plain versions,
    and the deliberately wrong attentions the check must tell apart. With
    ``int8`` the caches are ``QuantizedKV`` and the kernels are the int8
    forms (the plain versions read the dequantized cache)."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    i32 = dict(dtype=torch.int32, device=table.device)

    def one(n):
        return torch.tensor([n], **i32)

    def ctx(kc, vc, total):
        return att.gather_kv(kc, vc, table[: -(-total // BS)])

    def ragged_args(q, kc, vc, total):
        return q, kc, vc, table[None], one(0), one(q.shape[0]), one(total)

    def plain_prefill(q, kc, vc, total, start=0):
        return cuda_prefill.flash_extend_reference(q, *ctx(kc, vc, total), start, total)

    def plain_decode(q, kc, vc, total):
        return att.paged_decode_attention(
            q.reshape(1, H, D), kc, vc, table[None], one(total)).reshape(q.shape)

    def plain_ragged(q, kc, vc, total):
        return att.ragged_paged_attention(*ragged_args(q, kc, vc, total))

    def kernel_prefill(q, kc, vc, total):
        if not int8:
            return cuda_prefill.flash_extend_attention(q, *ctx(kc, vc, total), 0, total)
        kq, vq, ks, vs = att.gather_kv_quant(kc, vc, table[: -(-total // BS)])
        return cuda_prefill.flash_extend_attention(q, kq, vq, 0, total,
                                                   k_scales=ks, v_scales=vs)

    def roll(c):
        if int8:
            return QuantizedKV(c.data.roll(1, dims=2), c.scale.roll(1, dims=1))
        return c.roll(1, dims=2)

    def rotated(fn):
        # query-head group i reads kv head i+1: a wrong GQA map
        return lambda q, kc, vc, total: fn(q, roll(kc), roll(vc), total)

    def no_mask(q, kc, vc, total):
        # every query sees all `total` keys
        return plain_prefill(q, kc, vc, total, start=total - 1)

    return {
        "kernels": (
            kernel_prefill,
            lambda q, kc, vc, total: cuda_attention.paged_decode_attention(
                q.reshape(1, H, D), kc, vc, table[None], one(total),
                max_seq_len=total).reshape(q.shape),
            lambda q, kc, vc, total: cuda_unified.ragged_paged_attention(
                *ragged_args(q, kc, vc, total), max_q_len=q.shape[0]),
        ),
        "plain": (plain_prefill, plain_decode, plain_ragged),
        "mutant: no causal mask": (no_mask, plain_decode, no_mask),
        "mutant: each query's own key dropped": (
            lambda q, kc, vc, total: plain_prefill(q, kc, vc, total, start=-1),
            lambda q, kc, vc, total: plain_decode(q, kc, vc, total - 1),
            lambda q, kc, vc, total: plain_ragged(q, kc, vc, total - 1),
        ),
        "mutant: kv heads rotated": tuple(
            rotated(f) for f in (plain_prefill, plain_decode, plain_ragged)),
    }


# the wrong attentions the model check must catch: each one's reading must
# exceed MODEL_REL_TOL on every seed
MODEL_MUTANTS = ("mutant: no causal mask", "mutant: each query's own key dropped",
                 "mutant: kv heads rotated")


def model_logits(torch, cfg, params, paths, prompt, extra, int8=False):
    """Last-position logits [1, V] (f32) of a prefill, 3 decode steps and a
    2-token ragged step, through each path's attention, per path; the
    model's layers hand their attention attributes (gemma: window,
    softcap; gpt-oss: window, sinks) to the path. The plain paths of an
    expert family run its plain expert loop. With ``int8`` the caches are int8 and written as
    the engine writes them: the prefill quantizes whole blocks (pad rows
    zero), later tokens requantize their block one row at a time."""
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    forward, lm_logits = registry.forward_fn(cfg), registry.lm_logits_fn(cfg)
    if registry.is_gptoss(cfg):
        from dynamo_tpu_torch.models import gptoss

        # the kernel path runs the engine's grouped expert products, the
        # plain paths the plain expert loop
        plain_forward = functools.partial(forward, expert_fn=gptoss.experts_plain)
    elif registry.is_moe(cfg) or registry.is_mla(cfg):
        from dynamo_tpu_torch.models import moe

        plain_forward = functools.partial(forward, expert_fn=moe.experts_plain)
    else:
        plain_forward = forward
    dev = params["embed"].device
    pages = -(-(len(prompt) + len(extra)) // BS) + 1
    nb = pages + 3
    table = torch.arange(3, 3 + pages, dtype=torch.int32, device=dev)
    n = len(prompt)
    logits = {}
    for name, (prefill, decode, ragged) in paths(table).items():
        fwd = forward if name == "kernels" else plain_forward
        shape = (nb, BS, cfg.num_kv_heads, cfg.head_dim)

        def cache():
            if int8:
                return QuantizedKV(torch.zeros(shape, dtype=torch.int8, device=dev),
                                   torch.zeros(shape[0], shape[2], device=dev))
            return torch.zeros(shape, dtype=cfg.dtype, device=dev)

        kcs = [cache() for _ in range(cfg.num_layers)]
        vcs = [cache() for _ in range(cfg.num_layers)]

        def run(tokens, start, attn):
            pos = torch.arange(start, start + len(tokens), device=dev)
            blocks, offs = table[pos // BS], pos % BS

            def write_int8(kc, vc, k, v):
                if start == 0:
                    pad = -len(tokens) % BS
                    k, v = (torch.cat([x, x.new_zeros(pad, *x.shape[1:])]) for x in (k, v))
                    att.write_prefill_kv(kc, vc, k, v, table[: k.shape[0] // BS])
                    return
                for j in range(len(tokens)):
                    att.write_decode_kv(kc, vc, k[j:j + 1], v[j:j + 1],
                                        blocks[j:j + 1], offs[j:j + 1])

            def attend(q, k, v, i, **attrs):
                k, v = k.reshape(-1, *k.shape[-2:]), v.reshape(-1, *v.shape[-2:])
                if int8:
                    write_int8(kcs[i], vcs[i], k, v)
                else:
                    att.write_decode_kv(kcs[i], vcs[i], k, v, blocks, offs)
                return attn(q, kcs[i], vcs[i], start + len(tokens), **attrs)

            hidden = fwd(params, cfg, torch.as_tensor(tokens, device=dev), pos, attend)
            return lm_logits(params, cfg, hidden.reshape(-1, cfg.hidden_size)[-1:]).float()

        with torch.inference_mode():
            out = [run(prompt, 0, prefill)]
            out += [run(extra[j:j + 1], n + j, decode) for j in range(3)]
            out.append(run(extra[3:5], n + 3, ragged))
        logits[name] = out
    return logits


def model_check(torch, tag, cfg, prompt_len, seed_base, weight_sets, paths, int8=False):
    """``cfg`` at full width and its configured depth, per seed in
    MODEL_SEEDS: the kernel path's logits against the plain path's at every
    step, and the same reading for each mutant. ``weight_sets``: (adjust,
    the mutants read on those weights) pairs, ``adjust(cfg, params, rng)``
    changing the seed's random weights in place (None: as drawn); the
    kernel path is read on every set. ``paths(table, mutants)`` gives the
    attention paths; ``int8`` runs on int8 caches. Every mutant's reading
    must exceed MODEL_REL_TOL on every seed. Returns (worst kernel reading,
    least reading of each mutant over the seeds, max |logit|)."""
    from dynamo_tpu_torch.models import registry

    dev = torch.device("cuda")
    readings: dict = {}
    spread = 0.0
    for seed in MODEL_SEEDS:
        rng = np.random.default_rng(seed_base + seed)
        prompt = rng.integers(0, cfg.vocab_size, size=prompt_len)
        extra = rng.integers(0, cfg.vocab_size, size=5)   # 3 decode tokens + a 2-token step
        for adjust, mutants in weight_sets:
            params = registry.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
            if adjust is not None:
                adjust(cfg, params, rng)
            logits = model_logits(torch, cfg, params, lambda t: paths(t, mutants),
                                  prompt, extra, int8)
            plain = logits.pop("plain")
            spread = max(spread, max(b.abs().max().item() for b in plain))
            for name, got in logits.items():
                if name == "kernels" and not all(torch.isfinite(a).all() for a in got):
                    raise AssertionError(f"{tag} seed {seed}: kernel logits not finite")
                rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, plain))
                readings.setdefault(name, []).append(rel)
            del params, logits, plain
            torch.cuda.empty_cache()
    for name, rels in readings.items():
        log(f"{tag}: {name}: relative L2 of last-position logits vs plain, worst step per "
            f"seed {MODEL_SEEDS}" + (" and weight set" if len(weight_sets) > 1 else "")
            + ": " + ", ".join(f"{r:.4g}" for r in rels))
    worst = max(readings["kernels"])
    if worst > MODEL_REL_TOL:
        raise AssertionError(f"{tag}: kernel logits differ from plain by {worst:.4g} "
                             f"relative L2 (limit {MODEL_REL_TOL})")
    for name in readings:
        if name != "kernels" and min(readings[name]) <= MODEL_REL_TOL:
            raise AssertionError(f"{tag}: the check cannot tell {name} from the plain "
                                 f"path ({min(readings[name]):.4g} <= {MODEL_REL_TOL})")
    return worst, {n: min(r) for n, r in readings.items() if n != "kernels"}, spread


def unified_attention_paths(torch, table, mutants):
    """The Gemma and gpt-oss model checks' attention paths: every step
    (prefill, decode, ragged) is one row of the unified kernel, as the
    engine serves such a layer, or of its plain version, with the layer's
    attributes (window, softcap, sinks); ``mutants`` names the wrong
    attentions to add (ATTR_MUTANTS)."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    i32 = dict(dtype=torch.int32, device=table.device)

    def row(q, kc, vc, total):
        one = [torch.tensor([n], **i32) for n in (0, q.shape[0], total)]
        return (q, kc, vc, table[None], *one)

    def kernel(q, kc, vc, total, window=None, **attrs):
        if window:   # the kernel's form: an [R] windows array
            attrs["windows"] = torch.tensor([window], **i32)
        return cuda_unified.ragged_paged_attention(*row(q, kc, vc, total),
                                                   max_q_len=q.shape[0], **attrs)

    def plain(q, kc, vc, total, **attrs):
        return att.ragged_paged_attention(*row(q, kc, vc, total), **attrs)

    def wrong(change):
        fn = lambda q, kc, vc, total, **attrs: plain(q, kc, vc, total, **change(attrs))
        return (fn, fn, fn)

    paths = {"kernels": (kernel,) * 3, "plain": (plain,) * 3}
    for name in mutants:
        paths[name] = wrong(ATTR_MUTANTS[name])
    return paths


def _drop(key):
    return lambda attrs: dict(attrs, **{key: None})


def _window_plus(n):
    def change(attrs):
        w = attrs.get("window")
        return dict(attrs, window=None if w is None else w + n)
    return change


# the wrong attentions the Gemma and gpt-oss model checks must catch
ATTR_MUTANTS = {
    "mutant: window dropped": _drop("window"),
    "mutant: window one page too wide": _window_plus(BS),
    "mutant: softcap dropped": _drop("softcap"),
    "mutant: sinks dropped": _drop("sinks"),
    "mutant: window one key too wide": _window_plus(1),
}
# (preset, layers, prompt tokens): gemma2-2b's first two layers (sliding,
# full) over a prompt 1.5 windows long; gemma3-4b's first six (five sliding,
# one full) over a prompt ~2 windows long
GEMMA_MODEL_CHECKS = (("gemma2_2b", 2, 6000), ("gemma3_4b", 6, 2000))
# q/k projection scale of the softcap mutant's weights: at the published
# init the attention logits are ~N(0, 1), where a cap of 50 changes nothing
# measurable; x2 on both makes them ~N(0, 16), where it bends the largest
GEMMA_SHARP_QK = 2.0


def gemma_model_check(torch, preset, num_layers, prompt_len):
    """model_check for ``preset`` cut to ``num_layers``. Weights at the
    published init scale (attention broad: a window edge moves the output
    most) carry the window mutants; with a softcap, the same weights with
    q/k projections x GEMMA_SHARP_QK carry the softcap mutant."""
    from dynamo_tpu_torch.models import gemma

    cfg = dataclasses.replace(getattr(gemma.GemmaConfig, preset)(), num_layers=num_layers)
    sets = [(None, ("mutant: window dropped", "mutant: window one page too wide"))]
    if cfg.attn_logit_softcap:
        sets.append((sharpen_qk(GEMMA_SHARP_QK), ("mutant: softcap dropped",)))
    return model_check(torch, f"model {preset} x{num_layers} layers", cfg, prompt_len, 200,
                       sets, lambda t, mutants: unified_attention_paths(torch, t, mutants))


def sharpen_qk(factor):
    """A model check's weight adjustment: q/k projections times
    ``factor`` (with per-head q/k norms, gemma's, the norms' 1 + w)."""
    def adjust(cfg, params, rng):
        for lp in params["layers"]:
            if cfg.qk_norm:
                lp["q_norm"] += factor - 1.0
                lp["k_norm"] += factor - 1.0
            else:
                lp["wq"] *= factor
                lp["wk"] *= factor
    return adjust


# gpt-oss-20b cut to its first two layers (sliding, full) over a prompt of
# 1500 tokens, ~12 windows
GPTOSS_MODEL_CHECK = (2, 1500)
# the router bias that pins each layer's top 4 (GPTOSS_ROUTER_MARGIN above
# the others' init logits, ~N(0, 1)): a token whose 4th and 5th router
# logits lie closer than the two paths' bf16 rounding would take other
# experts on each path, a jump of the function that is no kernel's error
GPTOSS_ROUTER_MARGIN = 12.0
# sinks of the sink mutant's weights: at the init scale a window's 128 keys
# hold a softmax mass of ~128 * e^1.6 ~ e^6.5, so a sink near 6 takes a
# large share of a sliding layer's attention
GPTOSS_SINK_MEAN = 6.0
# the window mutant's weights: on sliding layers q and k are their biases
# alone, one rotary pair at the frequency w nearest pi / (2 * window), so
# that score(p, j) = -c^2 f^2 cos(w (p - j)) / sqrt(d) rises with the key's
# age across the window, by GPTOSS_EDGE_STEP between its two oldest keys
# (f: the YaRN attention factor): each query attends mostly to the oldest
# keys it sees, and one key more moves it to another token's value
GPTOSS_EDGE_STEP = 3.0


def gptoss_pin_router(cfg, params, rng):
    for lp in params["layers"]:
        chosen = rng.permutation(cfg.num_experts)[:cfg.num_experts_per_tok]
        lp["b_router"][chosen.tolist()] += GPTOSS_ROUTER_MARGIN


def gptoss_sink_weights(cfg, params, rng):
    """The sink mutant's weights: pinned routers, sinks N(GPTOSS_SINK_MEAN, 1)."""
    import torch

    gptoss_pin_router(cfg, params, rng)
    for lp in params["layers"]:
        lp["sinks"].copy_(torch.as_tensor(
            GPTOSS_SINK_MEAN + rng.standard_normal(cfg.num_heads), dtype=torch.float32))


def gptoss_edge_weights(cfg, params, rng):
    """The window mutant's weights (GPTOSS_EDGE_STEP): pinned routers; on
    sliding layers q = R(p) bq, k = R(j) bk with bq = -c e_i, bk = c e_i on
    one rotary pair i, and sinks at -30 (out of the way)."""
    import math

    import torch
    from dynamo_tpu_torch.models import gptoss

    gptoss_pin_router(cfg, params, rng)
    w = cfg.sliding_window
    inv_freq, factor = gptoss.yarn_inv_freq(cfg)
    i = int((inv_freq - math.pi / (2 * w)).abs().argmin())
    omega = float(inv_freq[i])
    if not 0 < omega * w < math.pi:
        raise AssertionError(f"model gpt-oss: no rotary pair rises across the window ({omega})")
    c = math.sqrt(GPTOSS_EDGE_STEP * math.sqrt(cfg.head_dim)
                  / (factor ** 2 * omega * math.sin(omega * w)))
    for li, lp in enumerate(params["layers"]):
        if cfg.window_for_layer(li) is None:
            continue
        lp["wq"].zero_()
        lp["wk"].zero_()
        bq = lp["bq"].view(cfg.num_heads, cfg.head_dim)
        bk = lp["bk"].view(cfg.num_kv_heads, cfg.head_dim)
        bq.zero_()
        bk.zero_()
        bq[:, i] = -c
        bk[:, i] = c
        lp["sinks"].fill_(-30.0)


def gptoss_model_check(torch):
    """model_check for gpt-oss-20b cut to GPTOSS_MODEL_CHECK's layers: the
    kernel path (the unified kernel at d = 64, the grouped expert products)
    against the plain path (plain attention, the plain expert loop). The
    sink mutant reads on weights whose sinks carry mass, the one-key window
    mutant on weights whose sliding layers attend to a window's oldest keys
    (GPTOSS_EDGE_STEP); both sets pin the routers (GPTOSS_ROUTER_MARGIN)."""
    from dynamo_tpu_torch.models import gptoss

    layers, prompt_len = GPTOSS_MODEL_CHECK
    cfg = dataclasses.replace(gptoss.GptOssConfig.gpt_oss_20b(), num_layers=layers)
    sets = [(gptoss_sink_weights, ("mutant: sinks dropped",)),
            (gptoss_edge_weights, ("mutant: window one key too wide",))]
    return model_check(torch, f"model gpt-oss-20b x{layers} layers", cfg, prompt_len, 300,
                       sets, lambda t, mutants: unified_attention_paths(torch, t, mutants))


# ------------------------------------------------------------- phase 4
def kernel_counters() -> dict:
    """Every kernel wrapper's launch counter, by the report's short name."""
    from dynamo_tpu_torch.ops import block_copy as bc
    from dynamo_tpu_torch.ops import cuda_attention, cuda_mla, cuda_prefill, cuda_unified

    return {
        "latent": cuda_mla.KERNEL,
        "decode": cuda_attention.KERNEL, "flash_extend": cuda_prefill.KERNEL,
        "unified": cuda_unified.KERNEL, "decode_int8": cuda_attention.KERNEL_INT8,
        "flash_extend_int8": cuda_prefill.KERNEL_INT8,
        "unified_int8": cuda_unified.KERNEL_INT8, "gather": bc.GATHER,
        "scatter": bc.SCATTER, "copy": bc.COPY, "merge": cuda_unified.MERGE,
    }


def launch_counters() -> dict:
    """kernel_counters, and the unified kernel's windowed launches."""
    from dynamo_tpu_torch.ops import cuda_unified

    return {**kernel_counters(), "unified_windowed": cuda_unified.WINDOWED}


def reset_launches() -> None:
    for k in launch_counters().values():
        k.launches = k.replayed = 0


def read_launches() -> dict:
    """Launches by kernel since reset_launches, CUDA-graph replays
    included (each replay counts the launches its capture recorded), and
    under "replayed" the share of them that replays made."""
    counters = launch_counters()
    out = {name: k.launches for name, k in counters.items()}
    out["replayed"] = {name: k.replayed for name, k in counters.items()}
    return out


def device_time_by_kind(prof, n_top: int = 10) -> dict:
    """Summed kernel time (ms) from a CUDA-activity profile, by kind, and
    the ``n_top`` kernels by time."""
    # (torch's own CUTLASS kernels serve torch._grouped_mm: gpt-oss's experts)
    kinds = {"decode_kernel": "paged_decode_kernel", "flash_kernel": "flash_extend_kernel",
             "unified_kernel": "unified_kernel", "merge_kernel": "merge_kernel",
             "latent_kernel": "latent_kernel",
             "grouped_gemm": "enable_3x_kernel_for_sm9x"}
    gemm_tags = ("gemm", "nvjet", "xmma", "cutlass", "cublas")
    out = dict.fromkeys(list(kinds) + ["gemm", "other"], 0.0)
    n, top = 0, []
    for e in prof.key_averages():
        t = e.self_device_time_total / 1e3
        if t <= 0:
            continue
        n += e.count
        name = e.key
        top.append((t, e.count, name[:80]))
        kind = next((k for k, tag in kinds.items() if tag in name), None)
        if kind is None:
            kind = "gemm" if any(g in name.lower() for g in gemm_tags) else "other"
        out[kind] += t
    out["kernels"] = n
    out["top"] = [[name, round(t, 3), c] for t, c, name in sorted(top, reverse=True)[:n_top]]
    return out


async def serve(torch, profile: bool = False):
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context

    mcfg = LlamaConfig.llama3_8b()
    cfg = TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS,
                            max_batch_size=8, max_context=4096, seed=0)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg)
    torch.cuda.synchronize()
    log(f"serving: llama3-8b preset, {mcfg.num_layers} layers, random bf16 weights "
        f"(seed 0) ready in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    tok = ByteTokenizer()
    rng = np.random.default_rng(3)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    lens = [120, 2600, 400, 1100, 3000, 180, 750, 1600, 2000, 900]
    prompts = []
    for n in lens:
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=n))
        prompts.append(tok.encode(text)[:n])
    max_tokens = 32
    sampled = 3   # one seeded sampled request; the rest are greedy
    # ITL is the mean gap between a request's tokens: (last arrival - first)
    # over tokens - 1, since one output carries a whole horizon's tokens
    stats = []

    async def one(i, prompt):
        await asyncio.sleep(0.25 * i)   # staggered arrivals
        samp = (SamplingOptions(temperature=0.8, top_p=0.95, seed=7) if i == sampled
                else SamplingOptions(temperature=0.0))
        req = PreprocessedRequest(request_id=f"r{i}", model="llama3-8b",
                                  token_ids=prompt, sampling=samp,
                                  stop=StopConditions(max_tokens=max_tokens))
        t_sub = time.perf_counter()
        stamps, toks, finish = [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
            finish = out.finish_reason or finish
        stats.append({"i": i, "prompt": len(prompt), "tokens": toks, "finish": finish,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                                if len(stamps) > 1 else None)})

    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    reset_launches()
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    launches = read_launches()
    for s in sorted(stats, key=lambda s: s["i"]):
        if len(s["tokens"]) != max_tokens or s["finish"] != "length":
            raise AssertionError(f"request {s['i']}: {len(s['tokens'])} tokens, "
                                 f"finish {s['finish']!r}; expected {max_tokens}, 'length'")
        if not all(0 <= t < mcfg.vocab_size for t in s["tokens"]):
            raise AssertionError(f"request {s['i']}: token id outside the vocab")
    for name in ("decode", "flash_extend", "unified"):
        if launches[name] <= 0:
            raise AssertionError(f"the {name} kernel never launched while serving")
    if engine.step_counts["mixed"] <= 0:
        raise AssertionError(f"no fused mixed step ran: {engine.step_counts}")
    if prof is not None:
        by_kind = device_time_by_kind(prof)
        busy_ms = sum(v for k, v in by_kind.items() if k not in ("kernels", "top"))
        return {"wall_s": wall, "device_busy_ms": busy_ms,
                "busy_share": busy_ms / (wall * 1e3), "device_ms": by_kind,
                "steps": dict(engine.step_counts), **horizon_report(engine), "launches": launches}
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats)
    n_out = sum(len(s["tokens"]) for s in stats)
    return {
        "requests": len(stats), "prompt_tokens": lens, "max_tokens": max_tokens,
        "wall_s": wall, "output_tok_s": n_out / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
        "steps": dict(engine.step_counts), **horizon_report(engine),
        "launches": launches,
    }


# int8 + KVBM serving: a device pool small enough that the churn wave evicts
# the first wave's prompt blocks, a G2 host tier large enough to hold every
# block both waves offload, and a third wave repeating three first-wave
# prompts, which then onboard from G2
KVBM_DEVICE_BLOCKS = 512
KVBM_HOST_BLOCKS = 2048
KVBM_FIRST = (2600, 1100, 3000)
KVBM_CHURN = (1600,) * 6


class ErrorLog:
    """Counts ERROR records of the port's loggers (an onboard or offload
    failure is logged, and any such record fails the run)."""

    def __init__(self):
        import logging

        self.records = []
        handler = logging.Handler(level=logging.ERROR)
        handler.emit = self.records.append
        self.logger = logging.getLogger("dynamo_tpu_torch")
        self.logger.addHandler(handler)
        self.handler = handler

    def close(self):
        self.logger.removeHandler(self.handler)


async def serve_kvbm(torch):
    """TorchEngine(kv_dtype="int8", kvbm=KvbmTiers(...)) on the llama3-8b
    preset at 32 layers: first wave, churn wave, repeat wave. Hard checks:
    token counts and finish reasons, every int8 attention kernel and the
    gather and scatter kernels launched, blocks onboarded and cached tokens
    on every repeat, an onboarded device block re-encoding bit-exactly to
    its stored G2 bytes, and no onboard or offload error. Unprofiled."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.kvbm.layout import QuantizedBlockCodec, block_shape_for
    from dynamo_tpu_torch.kvbm.pool import KvbmTiers
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context
    from dynamo_tpu_torch.tokens import compute_sequence_hashes

    mcfg = LlamaConfig.llama3_8b()
    cfg = TorchEngineConfig(model=mcfg, num_blocks=KVBM_DEVICE_BLOCKS, block_size=BS,
                            max_batch_size=8, max_context=4096, seed=0, kv_dtype="int8")
    codec = QuantizedBlockCodec(block_shape_for(mcfg, BS, "int8"))
    kvbm = KvbmTiers(codec.nbytes, host_capacity_bytes=KVBM_HOST_BLOCKS * codec.nbytes)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, kvbm=kvbm)
    torch.cuda.synchronize()
    log(f"serving int8+kvbm: llama3-8b preset, {mcfg.num_layers} layers, int8 KV "
        f"({KVBM_DEVICE_BLOCKS} device blocks), G2 host tier of {KVBM_HOST_BLOCKS} "
        f"blocks x {codec.nbytes} B, ready in {time.perf_counter() - t0:.1f} s")
    tok = ByteTokenizer()
    rng = np.random.default_rng(4)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]

    def prompt(n):
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=n))
        return tok.encode(text)[:n]

    first = [prompt(n) for n in KVBM_FIRST]
    churn = [prompt(n) for n in KVBM_CHURN]
    max_tokens = 32
    stats = []

    async def one(tag, i, toks):
        await asyncio.sleep(0.25 * i)
        req = PreprocessedRequest(request_id=f"{tag}{i}", model="llama3-8b", token_ids=toks,
                                  sampling=SamplingOptions(temperature=0.0),
                                  stop=StopConditions(max_tokens=max_tokens))
        t_sub = time.perf_counter()
        stamps, out_toks, finish, cached = [], [], None, None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                out_toks.extend(out.token_ids)
            if "cached_tokens" in (out.annotations or {}):
                cached = out.annotations["cached_tokens"]
            finish = out.finish_reason or finish
        stats.append({"wave": tag, "i": i, "prompt": len(toks), "tokens": out_toks,
                      "finish": finish, "cached": cached,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(out_toks) - 1)
                                if len(stamps) > 1 else None)})

    async def wave(tag, prompts):
        await asyncio.gather(*(one(tag, i, p) for i, p in enumerate(prompts)))
        await engine.flush_offload()

    # offload batches and onboard calls, counted around the engine's own
    # methods: each must be one launch of the page-copy kernel
    calls = {"offload_batches": 0, "onboards": 0}

    def counted(key, fn):
        def call(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return call

    engine._enqueue_offload_gather = counted("offload_batches", engine._enqueue_offload_gather)
    engine._scatter_blocks = counted("onboards", engine._scatter_blocks)
    errors = ErrorLog()
    reset_launches()
    t0 = time.perf_counter()
    try:
        await wave("first", first)
        await wave("churn", churn)
        hashes = [compute_sequence_hashes(p, BS)[: (len(p) - 1) // BS] for p in first]
        resident = [len(engine.allocator.match_prefix(h)) for h in hashes]
        await wave("repeat", first)
    finally:
        engine.stop()
        torch.cuda.synchronize()
        errors.close()
    wall = time.perf_counter() - t0
    launches = read_launches()
    kstats = kvbm.stats()
    by = {(s["wave"], s["i"]): s for s in stats}
    for s in stats:
        if len(s["tokens"]) != max_tokens or s["finish"] != "length":
            raise AssertionError(f"int8+kvbm {s['wave']} {s['i']}: {len(s['tokens'])} "
                                 f"tokens, finish {s['finish']!r}")
    for name in ("decode_int8", "flash_extend_int8", "unified_int8", "gather", "scatter"):
        if launches[name] <= 0:
            raise AssertionError(f"int8+kvbm: the {name} kernel never launched: {launches}")
    if (launches["gather"], launches["scatter"]) != (calls["offload_batches"], calls["onboards"]):
        raise AssertionError(f"int8+kvbm: {launches['gather']} gather launches for "
                             f"{calls['offload_batches']} offload batches, "
                             f"{launches['scatter']} scatter launches for "
                             f"{calls['onboards']} onboards")
    if errors.records or engine.offload_errors or kstats["errors"]:
        raise AssertionError(
            f"int8+kvbm: {len(errors.records)} error records, {engine.offload_errors} offload "
            f"errors, {kstats['errors']} tier errors: "
            + "; ".join(r.getMessage() for r in errors.records[:3]))
    if kstats["onboarded"] <= 0:
        raise AssertionError(f"int8+kvbm: no block onboarded from the tiers: {kstats}")
    for i in range(len(first)):
        if not by[("repeat", i)]["cached"]:
            raise AssertionError(f"int8+kvbm: repeat {i} reused no cached tokens")
    # an onboarded block (the first that was not on the device before the
    # repeat wave) re-encodes bit-exactly to its stored G2 bytes
    h = hashes[0][resident[0]]
    stored = kvbm.host.get(h)
    (bid,) = engine.allocator.match_prefix([h])
    pay = np.empty(codec.payload_shape, np.int8)
    scl = np.empty(codec.scales_shape, np.float32)
    for li, (kc, vc) in enumerate(zip(engine.k_caches, engine.v_caches)):
        pay[li, 0], pay[li, 1] = kc.data[bid].cpu().numpy(), vc.data[bid].cpu().numpy()
        scl[li, 0], scl[li, 1] = kc.scale[bid].cpu().numpy(), vc.scale[bid].cpu().numpy()
    if stored is None or not np.array_equal(codec.encode(pay, scl), stored):
        raise AssertionError("int8+kvbm: an onboarded block differs from its stored G2 bytes")
    same = sum(by[("repeat", i)]["tokens"] == by[("first", i)]["tokens"]
               for i in range(len(first)))
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats)
    return {
        "requests": len(stats), "waves": {"first": list(KVBM_FIRST),
                                          "churn": list(KVBM_CHURN), "repeat": list(KVBM_FIRST)},
        "max_tokens": max_tokens, "wall_s": wall,
        "output_tok_s": sum(len(s["tokens"]) for s in stats) / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
        "repeat_ttft_s": [by[("repeat", i)]["ttft_s"] for i in range(len(first))],
        "first_ttft_s": [by[("first", i)]["ttft_s"] for i in range(len(first))],
        "repeat_cached_tokens": [by[("repeat", i)]["cached"] for i in range(len(first))],
        "resident_blocks_before_repeat": resident,
        "repeats_streaming_the_same_greedy_tokens": f"{same} of {len(first)}",
        "kvbm": kstats, "steps": dict(engine.step_counts), **horizon_report(engine), "launches": launches,
        **calls, "onboarded_block_bit_exact": True,
    }


# Gemma serving: gemma2-2b at full depth and max_context 8192, prompts up to
# ~2 windows long; the int8 run is shorter (its kernel's path check)
GEMMA_INT8_PROMPTS = (4100, 1500, 300)
GEMMA_BLOCKS = 4096


async def serve_gemma(torch, int8=False, profile=False):
    """serve_windowed on the gemma2-2b preset (26 layers, random bf16
    weights from seed 0, max_context 8192): GEMMA_PROMPTS with 32 tokens
    each, or with ``int8`` GEMMA_INT8_PROMPTS with 16."""
    from dynamo_tpu_torch.models.gemma import GemmaConfig

    return await serve_windowed(
        torch, GemmaConfig.gemma2_2b(), "gemma", GEMMA_INT8_PROMPTS if int8 else GEMMA_PROMPTS,
        16 if int8 else 32, int8=int8, profile=profile, prompt_seed=6, sample_seed=11)


async def serve_windowed(torch, mcfg, tag, lens, max_tokens, int8=False, profile=False,
                         params=None, prompt_seed=6, sample_seed=11, expect=None,
                         forbid=None, split_module=None):
    """TorchEngine on ``mcfg``, a family whose every layer goes through the
    unified kernel (gemma, gpt-oss), on its defaults (GEMMA_BLOCKS device
    blocks, max_context 8192, batch 8; random bf16 weights from seed 0, or
    ``params``): prompts of ``lens`` tokens arriving 0.25 s apart,
    ``max_tokens`` each, request 2 seeded sampled and the rest greedy.
    Hard checks: token counts and finish reasons, fused mixed steps ran,
    the unified kernel (the int8 form with ``int8``) served windowed
    launches, and neither the decode nor the flash-extend kernel launched.
    Another family names the counters that must have launched
    (``expect``), those that must not (``forbid``) and the wrapper module
    whose split log the profiled run reads (``split_module``).
    Reports TTFT, ITL, tok/s, steps, the horizon's graphs, launches by
    kernel (replays counted) and the peak of allocated device memory.
    ``profile``: under torch.profiler (CUDA activity), returning the device
    time by kernel kind instead, and the rows the kernel split by its own
    count (it must split some: decode rows of thousands of keys)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.ops import cuda_unified
    from dynamo_tpu_torch.runtime import Context

    unified = "unified_int8" if int8 else "unified"
    expect = expect or (unified, "unified_windowed")
    if forbid is None:
        forbid = ("decode", "flash_extend", "decode_int8", "flash_extend_int8")
    split_module = split_module or cuda_unified
    cfg = TorchEngineConfig(model=mcfg, num_blocks=GEMMA_BLOCKS, block_size=BS,
                            max_batch_size=8, max_context=8192, seed=0,
                            kv_dtype="int8" if int8 else "model")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, params=params)
    torch.cuda.synchronize()
    if int8:
        tag += " int8"
    log(f"serving {tag}: {mcfg.num_layers} layers, random bf16 weights (seed 0), "
        f"{GEMMA_BLOCKS} device blocks, ready in {time.perf_counter() - t0:.1f} s; "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB allocated")
    tok = ByteTokenizer()
    rng = np.random.default_rng(prompt_seed)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    prompts = []
    for n in lens:
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=n))
        prompts.append(tok.encode(text)[:n])
    sampled = 2   # one seeded sampled request; the rest are greedy
    stats = []

    async def one(i, prompt):
        await asyncio.sleep(0.25 * i)
        samp = (SamplingOptions(temperature=0.8, top_p=0.95, seed=sample_seed) if i == sampled
                else SamplingOptions(temperature=0.0))
        req = PreprocessedRequest(request_id=f"g{i}", model=tag, token_ids=prompt,
                                  sampling=samp, stop=StopConditions(max_tokens=max_tokens))
        t_sub = time.perf_counter()
        stamps, toks, finish = [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
            finish = out.finish_reason or finish
        stats.append({"i": i, "tokens": toks, "finish": finish,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                                if len(stamps) > 1 else None)})

    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    reset_launches()
    # the kernel's own split counts of every launch: logging them costs
    # host time, so only the profiled runs (which report device time) do
    split_module.split_log = [] if prof is not None else None
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
        split_log, split_module.split_log = split_module.split_log, None
    wall = time.perf_counter() - t0
    launches = read_launches()
    for s in stats:
        if len(s["tokens"]) != max_tokens or s["finish"] != "length":
            raise AssertionError(f"{tag} request {s['i']}: {len(s['tokens'])} tokens, "
                                 f"finish {s['finish']!r}; expected {max_tokens}, 'length'")
        if not all(0 <= t < mcfg.vocab_size for t in s["tokens"]):
            raise AssertionError(f"{tag} request {s['i']}: token id outside the vocab")
    missing = [n for n in expect if launches[n] <= 0]
    if missing:
        raise AssertionError(f"{tag}: {missing} never launched: {launches}")
    split_rows = split_launches = None
    if split_log is not None:
        counts = [(n >= 2).sum() for _, n in split_log if n is not None]
        per_launch = torch.stack(counts).tolist() if counts else []
        split_rows, split_launches = sum(per_launch), sum(1 for c in per_launch if c)
        if not split_rows:
            raise AssertionError(f"{tag}: the kernel split no row (decode rows of up to "
                                 f"{max(lens)} keys) in {len(split_log)} launches")
    split = [n for n in forbid if launches[n]]
    if split:
        raise AssertionError(f"{tag}: layers went through {split}: {launches}")
    if engine.step_counts["mixed"] <= 0:
        raise AssertionError(f"{tag}: no fused mixed step ran: {engine.step_counts}")
    peak = torch.cuda.max_memory_allocated()
    if prof is not None:
        by_kind = device_time_by_kind(prof)
        busy_ms = sum(v for k, v in by_kind.items() if k not in ("kernels", "top"))
        return {"wall_s": wall, "device_busy_ms": busy_ms,
                "busy_share": busy_ms / (wall * 1e3), "device_ms": by_kind,
                "steps": dict(engine.step_counts), **horizon_report(engine), "launches": launches,
                "split_rows": split_rows, "launches_with_split_rows": split_launches}
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats)
    n_out = sum(len(s["tokens"]) for s in stats)
    return {
        "requests": len(stats), "prompt_tokens": list(lens), "max_tokens": max_tokens,
        "wall_s": wall, "output_tok_s": n_out / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
        "steps": dict(engine.step_counts), **horizon_report(engine), "launches": launches,
        "peak_allocated_bytes": peak,
    }


# ------------------------------------------------------------- phase 5
def horizon_report(engine) -> dict:
    """An engine's decode schedule (and the measurements behind an
    auto-tuned one) and its horizon graphs: count, capture seconds, pool
    bytes, replays."""
    c = engine.cfg
    return {"schedule": {"decode_steps": c.decode_steps, "decode_pipeline": c.decode_pipeline,
                         "cuda_graphs": c.cuda_graphs, **engine.schedule},
            "horizon": engine.horizon_stats()}


# decode-heavy traffic: 8 prompts of 128 tokens queued before the first
# tick, 256 output tokens each, on llama3-8b at 32 layers (full width and
# depth, random bf16 weights from seed 0), max_context 4096, 2048 blocks
HZ_PROMPTS, HZ_PROMPT_LEN, HZ_TOKENS = 8, 128, 256
HZ_SAMPLED = 3     # T 0.8, top-p 0.95, seed 7; the rest greedy
HZ_STEPS = 8


def horizon_prompts():
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer

    tok = ByteTokenizer()
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 123, size=rng.integers(2, 9))).decode()
             for _ in range(4000)]
    out = []
    for _ in range(HZ_PROMPTS):
        text = " ".join(words[int(i)] for i in rng.integers(0, len(words), size=HZ_PROMPT_LEN))
        out.append(tok.encode(text)[:HZ_PROMPT_LEN])
    return out


async def serve_decode_heavy(torch, params, prompts, stop=None, profile=False, mcfg=None,
                             tokens=HZ_TOKENS, max_context=4096, **knobs):
    """Serve the decode-heavy traffic once on a fresh engine over
    ``params`` (of ``mcfg``, default llama3-8b), ``tokens`` output tokens
    a request; ``stop``: pick_stop's (request, index, token). ``knobs``: the
    engine's decode_steps / decode_pipeline / cuda_graphs. Returns each
    request's tokens, finish and the sizes of its output chunks (one per
    horizon), TTFT / ITL / tok/s / wall, the tokens each request had when
    the last prompt's prefill ended (``pre``: horizons start there), and
    the engine's steps, horizon report and launches (replays counted)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.runtime import Context

    mcfg = mcfg or LlamaConfig.llama3_8b()
    cfg = TorchEngineConfig(model=mcfg, num_blocks=2048, block_size=BS, max_batch_size=8,
                            max_context=max_context, seed=0, **knobs)
    t0 = time.perf_counter()
    engine = TorchEngine(cfg, params=params)
    torch.cuda.synchronize()
    ready_s = time.perf_counter() - t0
    pre = {}
    accept = engine._accept_tokens

    def accept_and_mark(st, *a, **k):
        accept(st, *a, **k)
        live = [x for x in engine._slots if x is not None]
        if not pre and len(live) == HZ_PROMPTS and all(x.prefilled for x in live):
            pre.update({x.req.request_id: x.produced for x in live})

    engine._accept_tokens = accept_and_mark
    stats = []

    async def one(i, prompt):
        samp = (SamplingOptions(temperature=0.8, top_p=0.95, seed=7) if i == HZ_SAMPLED
                else SamplingOptions(temperature=0.0))
        ids = [stop[2]] if stop is not None and stop[0] == i else []
        req = PreprocessedRequest(request_id=f"h{i}", model="decode-heavy", token_ids=prompt,
                                  sampling=samp, stop=StopConditions(max_tokens=tokens,
                                                                     stop_token_ids=ids))
        t_sub = time.perf_counter()
        stamps, toks, chunks, finish = [], [], [], None
        async for out in engine.generate(req, Context()):
            if out.token_ids:
                stamps.append(time.perf_counter())
                toks.extend(out.token_ids)
            chunks.append(len(out.token_ids))
            finish = out.finish_reason or finish
        stats.append({"i": i, "tokens": toks, "finish": finish, "chunks": chunks,
                      "ttft_s": stamps[0] - t_sub if stamps else None,
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(toks) - 1)
                                if len(toks) > 1 else None)})

    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    reset_launches()
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    stats.sort(key=lambda x: x["i"])
    ttft = sorted(x["ttft_s"] for x in stats)
    itl = sorted(x["itl_s"] for x in stats)
    out = {"ready_s": ready_s, "wall_s": wall,
           "output_tok_s": sum(len(x["tokens"]) for x in stats) / wall,
           "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
           "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
           "pre": [pre.get(f"h{i}") for i in range(HZ_PROMPTS)],
           "steps": dict(engine.step_counts), **horizon_report(engine),
           "launches": read_launches(), "requests": stats}
    if prof is not None:
        by_kind = device_time_by_kind(prof, n_top=25)
        busy_ms = sum(v for k, v in by_kind.items() if k not in ("kernels", "top"))
        out.update(device_busy_ms=busy_ms, device_ms=by_kind)
    return out, engine


def pick_stop(free: dict):
    """(request, index, token): a greedy request's token whose first
    appearance in the free run falls mid-horizon (neither first nor last
    of its horizon of HZ_STEPS), after at least one whole horizon."""
    for r in free["requests"]:
        if r["i"] == HZ_SAMPLED:
            continue
        toks, pre = r["tokens"], free["pre"][r["i"]]
        for j in range(pre + HZ_STEPS, len(toks) - 1):
            if 0 < (j - pre) % HZ_STEPS < HZ_STEPS - 1 and toks[j] not in toks[:j]:
                return r["i"], j, toks[j]
    raise AssertionError("horizon: no greedy request samples a new token mid-horizon")


def check_same_streams(tag: str, run: dict, free: dict, stop) -> None:
    """``run`` streams the free run's tokens: every request all of them,
    the stopped one (``stop``: pick_stop's, or None) its tokens before the
    stop token, finishing "stop" with the stop inside a horizon."""
    i_stop, j, _ = stop if stop is not None else (None, None, None)
    pre = free["pre"]
    if run["pre"] != pre:
        raise AssertionError(f"{tag}: prefill phase ended at {run['pre']}, free run at {pre}")
    for r, f in zip(run["requests"], free["requests"]):
        want, finish = (f["tokens"][:j], "stop") if r["i"] == i_stop else (f["tokens"], "length")
        if r["tokens"] != want or r["finish"] != finish:
            first = next((n for n, (a, b) in enumerate(zip(r["tokens"], want)) if a != b),
                         min(len(r["tokens"]), len(want)))
            raise AssertionError(
                f"{tag}: request {r['i']} streamed {len(r['tokens'])} tokens ({r['finish']}), "
                f"expected {len(want)} ({finish}) of the one-step eager run; first "
                f"difference at token {first}")
    if stop is None:
        return
    last = [c for c in run["requests"][i_stop]["chunks"] if c][-1]
    if run["steps"]["horizon"] and not 0 < last < HZ_STEPS - 1:
        raise AssertionError(f"{tag}: the stop did not fall inside a horizon ({last} "
                             f"tokens in the last chunk)")


def random_horizon_state(torch, engine, lens, seed):
    """Random caches (every page), random output counts and prompt masks,
    and a horizon state over ``lens`` (0: an inactive row) with distinct
    pages per row, row 2 sampled with top-p and row 5 penalized."""
    hz, c = engine._horizon, engine.cfg
    hs = hz.state
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for cache in engine.k_caches + engine.v_caches:
        if hasattr(cache, "scale"):
            cache.data.copy_(torch.randint(-127, 128, cache.data.shape, generator=gen,
                                           device="cuda", dtype=torch.int8))
            cache.scale.copy_(torch.rand(cache.scale.shape, generator=gen, device="cuda") / 50)
        else:
            cache.normal_(generator=gen)
    B = c.max_batch_size
    n = c.decode_steps
    tables = torch.zeros(B, c.max_blocks_per_seq, dtype=torch.int32)
    nxt = 1
    for r, L in enumerate(lens):
        if L:
            k = -(-(L + n) // c.block_size)
            tables[r, :k] = torch.arange(nxt, nxt + k, dtype=torch.int32)
            nxt += k
    lens_t = torch.tensor(lens, dtype=torch.int32)
    active = lens_t > 0
    vals = {"tokens": torch.randint(0, engine.mcfg.vocab_size, (B,)), "seq_lens": lens_t,
            "steps": torch.arange(B) * 3, "tables": tables, "active": active,
            "count_rows": active, "sample_rows": active & (torch.arange(B) == 2),
            "seeds": torch.arange(B) + 11,
            "temps": torch.where(torch.arange(B) == 2, 0.8, 0.0),
            "top_ks": torch.zeros(B, dtype=torch.int64),
            "top_ps": torch.where(torch.arange(B) == 2, 0.95, 1.0),
            "min_ps": torch.zeros(B), "freqs": torch.zeros(B),
            "pres": torch.where(torch.arange(B) == 5, 0.5, 0.0),
            "reps": torch.where(torch.arange(B) == 5, 1.2, 1.0)}
    for name, v in vals.items():
        getattr(hs, name).copy_(v)
    engine.output_counts.copy_(torch.randint(0, 3, engine.output_counts.shape, generator=gen,
                                             device="cuda", dtype=torch.int32))
    engine.prompt_masks.copy_(torch.randint(0, 2, engine.prompt_masks.shape, generator=gen,
                                            device="cuda", dtype=torch.int8))
    return hz.key(max(lens) + n - 1, True)


def cache_arrays(caches):
    return [t for c in caches for t in ((c.data, c.scale) if hasattr(c, "scale") else (c,))]


def graph_equals_eager(torch, engine, tag: str, lens) -> dict:
    """From one random state: the horizon body run eagerly on cloned
    caches and output counts, then the captured graph replayed on the
    originals. The packed results, the carry, the output counts and every
    K/V page but scratch block 0 (which every inactive row writes, in an
    order that decides its contents) must be bit-identical."""
    hz = engine._horizon
    hs = hz.state
    key = random_horizon_state(torch, engine, lens, seed=9)
    carry0 = hs.carry.dev.clone()
    orig = (engine.k_caches, engine.v_caches, engine.output_counts)

    def clone(c):
        return type(c)(c.data.clone(), c.scale.clone()) if hasattr(c, "scale") else c.clone()

    engine.k_caches = [clone(c) for c in orig[0]]
    engine.v_caches = [clone(c) for c in orig[1]]
    engine.output_counts = orig[2].clone()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine._decode_multi(hs, *key)
    torch.cuda.synchronize()
    eager_s = time.perf_counter() - t0
    eager = (hs.packed.clone(), hs.carry.dev.clone(), engine.output_counts,
             cache_arrays(engine.k_caches + engine.v_caches))
    engine.k_caches, engine.v_caches, engine.output_counts = orig
    hs.carry.dev.copy_(carry0)
    graph, _ = hz.graphs[key]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    graphed = (hs.packed, hs.carry.dev, engine.output_counts,
               cache_arrays(engine.k_caches + engine.v_caches))
    for name, a, b in (("packed tokens and logprobs", eager[0], graphed[0]),
                       ("carry", eager[1], graphed[1]), ("output counts", eager[2], graphed[2])):
        if not torch.equal(a, b):
            raise AssertionError(f"horizon {tag}: graph replay's {name} differ from the "
                                 "eager horizon's")
    pages = 0
    for a, b in zip(eager[3], graphed[3]):
        if not torch.equal(a[1:], b[1:]):
            raise AssertionError(f"horizon {tag}: a K/V page differs between the graph "
                                 "replay and the eager horizon")
        pages += a.shape[0] - 1
    if not torch.isfinite(hs.packed[:, :, 1][:, hs.active]).all():
        raise AssertionError(f"horizon {tag}: logprobs not finite")
    return {"key": list(key), "lens": list(lens), "steps": hs.packed.shape[0],
            "eager_s": eager_s, "replay_s": replay_s, "pages_compared": pages,
            "cache_arrays": len(eager[3]), "bit_identical": True}


def graph_ms(torch, fn, reps: int = 50) -> float:
    """Milliseconds per replay of ``fn`` captured as a CUDA graph (the
    device time of that work inside a graph), CUDA events over ``reps``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        fn()
    graph.replay()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_step_parts(torch, mcfg) -> dict:
    """Device ms per decode step inside a graph, at the decode-heavy
    traffic's batch of 8: the Gumbel draw over [8, vocab] (every sampled
    step), and every layer's K and V decode write (the plain-PyTorch
    write, no kernel of its own) on bf16 and on int8 caches."""
    from dynamo_tpu_torch.engine.sampling import gumbel_noise_tensor
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops.quant import QuantizedKV

    B, L, nb = 8, mcfg.num_layers, 64
    gen = torch.Generator(device="cuda").manual_seed(4)
    seeds = torch.arange(B, device="cuda") + 7
    steps = torch.arange(B, device="cuda") * 5
    rows = torch.ones(B, dtype=torch.bool, device="cuda")
    shape = (nb, BS, mcfg.num_kv_heads, mcfg.head_dim)
    bf16 = [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for _ in range(2 * L)]
    int8 = [QuantizedKV(torch.randint(-127, 128, shape, generator=gen, device="cuda",
                                      dtype=torch.int8),
                        torch.rand(shape[0], shape[2], generator=gen, device="cuda") / 50)
            for _ in range(2 * L)]
    k = torch.randn(B, mcfg.num_kv_heads, mcfg.head_dim, generator=gen,
                    device="cuda").to(torch.bfloat16)
    blocks = torch.arange(1, B + 1, device="cuda") * 5
    offs = torch.arange(B, device="cuda") % BS + 1

    def writes(caches):
        for li in range(L):
            att.write_decode_kv(caches[2 * li], caches[2 * li + 1], k, k, blocks, offs)

    return {"gumbel_ms": graph_ms(torch, lambda: gumbel_noise_tensor(
                seeds, steps, mcfg.vocab_size, rows=rows)),
            "kv_write_bf16_ms": graph_ms(torch, lambda: writes(bf16)),
            "kv_write_int8_ms": graph_ms(torch, lambda: writes(int8)),
            "layers": L, "batch": B}


def horizon_phase(torch, smi: str) -> dict:
    """The decode horizon on the card: graph equals eager bit for bit
    (llama bf16, llama int8, gemma2-2b), the decode-heavy traffic served
    four ways on one set of weights -- (a) one eager step per tick, (b) an
    eager horizon of 8, (c) graphed horizons of 8 two in flight, (d) the
    auto-tuned schedule with graphs -- (b)-(d) streaming exactly (a)'s
    tokens, (d) again under the profiler, and the per-step device time of
    the Gumbel draw and the KV writes inside a graph."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.gemma import GemmaConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig

    out = {}
    mcfg = LlamaConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = registry.init_params(mcfg, gen, "cuda")
    prompts = horizon_prompts()
    runs = {}
    free, eng = asyncio.run(serve_decode_heavy(torch, params, prompts, decode_steps=1,
                                               decode_pipeline=1))
    del eng
    stop = pick_stop(free)
    out["stop"] = {"request": stop[0], "index": stop[1], "token": stop[2],
                   "horizon_offset": (stop[1] - free["pre"][stop[0]]) % HZ_STEPS}
    for s in free["requests"]:
        if len(s["tokens"]) != HZ_TOKENS or s["finish"] != "length":
            raise AssertionError(f"horizon (a): request {s['i']}: {len(s['tokens'])} tokens, "
                                 f"{s['finish']!r}")
    runs["a"] = free
    plans = (("b", dict(decode_steps=HZ_STEPS, decode_pipeline=1, cuda_graphs=False)),
             ("c", dict(decode_steps=HZ_STEPS, decode_pipeline=2)),
             ("d", {}))
    for tag, knobs in plans:
        gc.collect()
        torch.cuda.empty_cache()
        run, eng = asyncio.run(serve_decode_heavy(torch, params, prompts, stop=stop, **knobs))
        check_same_streams(f"horizon ({tag})", run, free, stop)
        if run["steps"]["horizon"] <= 0:
            raise AssertionError(f"horizon ({tag}): no horizon ran: {run['steps']}")
        for name in ("decode", "unified", "flash_extend"):
            if run["launches"][name] <= 0:
                raise AssertionError(f"horizon ({tag}): the {name} kernel never launched")
        if knobs.get("cuda_graphs", True):
            if run["horizon"]["replays"] != run["steps"]["horizon"]:
                raise AssertionError(f"horizon ({tag}): {run['horizon']} replays for "
                                     f"{run['steps']['horizon']} horizons")
            if run["launches"]["replayed"]["decode"] <= 0:
                raise AssertionError(f"horizon ({tag}): no decode launch came from a replay")
        runs[tag] = run
        if tag == "c":
            out["graph_equals_eager"] = {"llama3-8b bf16": graph_equals_eager(
                torch, eng, "llama bf16", [300, 1000, 2500, 4096 - HZ_STEPS, 64, 0, 1800, 17])}
        del eng
    for tag, run in runs.items():
        log(f"horizon ({tag}) on {smi}: schedule {run['schedule']}; "
            f"{run['output_tok_s']:.1f} tok/s, wall {run['wall_s']:.2f} s, TTFT median "
            f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), ITL "
            f"median {run['itl_s_median'] * 1e3:.2f} ms (max {run['itl_s_max'] * 1e3:.2f}); "
            f"steps {run['steps']}; graphs {run['horizon']}; launches {run['launches']}")
    gc.collect()
    torch.cuda.empty_cache()
    prof, eng = asyncio.run(serve_decode_heavy(torch, params, prompts, stop=stop,
                                               profile=True))
    del eng
    # busy share: the profiled rerun's device time over the unprofiled
    # run's wall (the profiler's own host work stretches the profiled wall)
    prof["busy_share"] = prof["device_busy_ms"] / (runs["d"]["wall_s"] * 1e3)
    steps_run = prof["steps"]["horizon"] * prof["schedule"]["decode_steps"] + sum(
        prof["steps"][k] for k in ("prefill", "decode", "mixed"))
    log(f"horizon (d) profiled on {smi}: device busy {prof['device_busy_ms']:.1f} ms, "
        f"{prof['busy_share']:.1%} of the unprofiled (d) wall of "
        f"{runs['d']['wall_s'] * 1e3:.1f} ms (profiled wall {prof['wall_s'] * 1e3:.1f} ms); "
        f"{prof['device_ms']['kernels']} kernels over {steps_run} forward passes "
        f"({prof['device_ms']['kernels'] / steps_run:.0f} each), "
        f"{prof['device_busy_ms'] / steps_run:.3f} device ms each; device ms "
        + json.dumps(prof["device_ms"]))
    out["runs"] = {tag: {k: v for k, v in run.items() if k != "requests"}
                   for tag, run in runs.items()}
    out["profiled_d"] = {k: v for k, v in prof.items() if k != "requests"}
    # graph against eager on the other caches and family
    gc.collect()
    torch.cuda.empty_cache()
    for tag, mk in (
            ("llama3-8b int8", lambda: TorchEngine(TorchEngineConfig(
                model=mcfg, num_blocks=2048, block_size=BS, max_batch_size=8, max_context=4096,
                kv_dtype="int8", decode_steps=HZ_STEPS, decode_pipeline=1), params=params)),
            ("gemma2-2b bf16", lambda: TorchEngine(TorchEngineConfig(
                model=GemmaConfig.gemma2_2b(), num_blocks=2048, block_size=BS,
                max_batch_size=8, max_context=8192, decode_steps=HZ_STEPS,
                decode_pipeline=1)))):
        eng = mk()
        lens = ([300, 1000, 2500, 4096 - HZ_STEPS, 64, 0, 1800, 17] if "llama" in tag
                else [300, 5000, 2500, 8192 - HZ_STEPS, 64, 0, 4500, 17])
        out["graph_equals_eager"][tag] = {**graph_equals_eager(torch, eng, tag, lens),
                                          **horizon_report(eng)}
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    for tag, r in out["graph_equals_eager"].items():
        log(f"horizon graph = eager, {tag}: bit-identical over {r['steps']} steps at key "
            f"{r['key']} ({r['pages_compared']} pages x {r['cache_arrays']} cache arrays); "
            f"eager {r['eager_s'] * 1e3:.1f} ms, replay {r['replay_s'] * 1e3:.1f} ms")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["step_parts"] = time_step_parts(torch, mcfg)
    p = out["step_parts"]
    log(f"horizon step parts inside a graph on {smi}, batch 8: Gumbel draw over "
        f"{mcfg.vocab_size} {p['gumbel_ms']:.4f} ms; K and V decode writes of "
        f"{p['layers']} layers {p['kv_write_bf16_ms']:.4f} ms bf16, "
        f"{p['kv_write_int8_ms']:.4f} ms int8")
    return out


# ------------------------------------------------------------- phase 6
# the expert FFN's check: token counts of a decode batch and of a prefill
# chunk at gpt-oss-20b width (H 2880, I 2880, E 32, K 4)
EXPERT_TOKENS = (8, 2048)
GPTOSS_BLOCKS = 4096
GPTOSS_HZ_TOKENS = 64


def expert_bound(cfg, topi, T) -> tuple:
    """(bound ms, bound_by, experts hit) of the expert FFN on T tokens
    routed to ``topi``: the bytes of the experts it hits (gate/up and down
    weights and biases, bf16), the tokens in and out and the routing, over
    the FLOPs of the T * K rows' two products."""
    H, I, K = cfg.hidden_size, cfg.intermediate_size, cfg.num_experts_per_tok
    hit = len(set(topi.flatten().tolist()))
    per_expert = 2 * (H * 2 * I + I * H + 2 * I + H)
    b, by = bound(hit * per_expert + 2 * 2 * T * H + T * K * (4 + 8),
                  2 * T * K * (H * 2 * I + I * H))
    return b, by, hit


def check_experts(torch, gen, timer) -> dict:
    """gpt-oss-20b's expert FFN at full width: ``experts_grouped`` (what
    the engine runs) against ``experts_plain`` (the expert loop in float32)
    at EXPERT_TOKENS tokens, routed by a random router, with non-zero
    biases; timed against its byte and FLOP bounds (no single PyTorch call
    computes it; the wait before each timed call covers its host work, some
    15 launches). Then the decode batch's form captured into a CUDA graph
    and replayed must equal its eager run bit for bit: the form the decode
    horizon captures (gptoss_phase finds its kernels in the profiled
    horizons)."""
    from dynamo_tpu_torch.models import gptoss

    if not hasattr(torch, "_grouped_mm"):
        raise AssertionError(f"torch {torch.__version__} has no torch._grouped_mm: the "
                             "grouped expert path cannot run")
    cfg = gptoss.GptOssConfig.gpt_oss_20b()
    p = gptoss.init_layer_params(cfg, gen, "cuda")
    for name in ("b_router", "b_gateup", "b_edown"):
        p[name].normal_(0.0, 0.1, generator=gen)
    out = {}
    for T in EXPERT_TOKENS:
        x = torch.randn(T, cfg.hidden_size, generator=gen, device="cuda").to(torch.bfloat16)
        routed = gptoss.route(p, cfg, x)
        got = gptoss.experts_grouped(p, cfg, x, routed)
        want = gptoss.experts_plain(p, cfg, x, routed).float()
        # per token: the grouped products round the gate/up and the down
        # outputs to bf16 where the plain loop keeps float32, a relative
        # error of a few 2^-9 on a row (no elementwise bound holds near 0);
        # a wrong expert, bias, lane or permutation moves a row by O(1)
        row_rel = ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
        if not torch.isfinite(got).all() or row_rel > KERNEL_ROW_REL:
            raise AssertionError(f"experts_grouped T={T}: rows differ from the plain loop by "
                                 f"{row_rel:.4g} relative L2 (limit {KERNEL_ROW_REL})")
        err = (got.float() - want).abs().max().item()
        b, by, hit = expert_bound(cfg, routed[1], T)
        ms = timer(lambda: gptoss.experts_grouped(p, cfg, x, routed), busy=2_000_000)
        out[T] = {"max_abs_err": err, "worst_row_rel": row_rel, "experts_hit": hit, "ms": ms,
                  "plain_ms": timer(lambda: gptoss.experts_plain(p, cfg, x, routed), reps=3),
                  "library_ms": None, "bound_ms": b, "bound_by": by}
        log(f"  experts_grouped T={T}: worst row relative L2 {row_rel:.3g} (limit "
            f"{KERNEL_ROW_REL}), max abs err {err:.3g} against the plain loop; "
            f"{ms:.4f} ms, {out[T]['plain_ms']:.4f} ms plain, bound {b:.4f} ms ({by}, "
            f"{hit} of {cfg.num_experts} experts hit)")
    # the decode batch's form inside a CUDA graph
    x = torch.randn(EXPERT_TOKENS[0], cfg.hidden_size, generator=gen,
                    device="cuda").to(torch.bfloat16)
    routed = gptoss.route(p, cfg, x)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager = gptoss.experts_grouped(p, cfg, x, routed)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y = gptoss.experts_grouped(p, cfg, x, routed)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(y, eager):
        raise AssertionError("experts_grouped: its graph replay differs from its eager run")
    log(f"  experts_grouped T={EXPERT_TOKENS[0]} captured into a CUDA graph: replay equals "
        "eager bit for bit")
    return out


def gptoss_phase(torch, gen, smi: str, flex) -> tuple:
    """gpt-oss-20b on the card (module docstring, phase 6). Returns (the
    kernel results by report name, the phase's report)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig, param_bytes
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.gptoss import GptOssConfig

    results, out = {}, {}
    timer = Timer(torch)
    # (a) the unified kernel at d = 64, bf16 and int8, and its merge
    for int8 in (False, True):
        t0 = time.perf_counter()
        r = check_unified_attrs(torch, gen, timer, GPTOSS, int8=int8, flex=flex)
        results[r["name"]] = r
        log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} over "
            f"{len(r['cases'])} cases (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row "
            f"{KERNEL_ROW_REL}) [{time.perf_counter() - t0:.1f} s]")
    r = check_merge(torch, gen, timer, GPTOSS)
    results[r["name"]] = r
    log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g}; {r['ms']:.4f} ms kernel, "
        f"{r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); the "
        f"sink counted once per split moves the split rows by "
        f"{r['sink_per_split_row_gap'][0]:.3g}-{r['sink_per_split_row_gap'][1]:.3g}")
    # (b) the expert FFN
    t0 = time.perf_counter()
    out["experts"] = check_experts(torch, gen, timer)
    log(f"experts on {smi}: " + json.dumps(out["experts"]) +
        f" [{time.perf_counter() - t0:.1f} s]")
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    # (c) the model check at full width, two layers
    t0 = time.perf_counter()
    worst, mutants, spread = gptoss_model_check(torch)
    out["model"] = {"worst": worst, "mutants": mutants, "max_logit": spread}
    log(f"model gpt-oss-20b: {GPTOSS_MODEL_CHECK[0]} layers at full width, prefill "
        f"{GPTOSS_MODEL_CHECK[1]} + 3 decode + a 2-token ragged step, {len(MODEL_SEEDS)} "
        f"seeds: kernels vs plain logits relative L2 {worst:.4g} at worst (limit "
        f"{MODEL_REL_TOL}); mutants at least "
        + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
        + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
    gc.collect()
    torch.cuda.empty_cache()
    # (d) gpt-oss-20b at all 24 layers on its defaults
    mcfg = GptOssConfig.gpt_oss_20b()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    out["load"] = {"s": time.perf_counter() - t0, "param_bytes": param_bytes(params),
                   "peak_allocated_bytes": torch.cuda.max_memory_allocated()}
    log(f"gpt-oss-20b: {mcfg.num_layers} layers, random bf16 weights (seed 0), "
        f"{out['load']['param_bytes'] / 1e9:.2f} GB, loaded in {out['load']['s']:.1f} s; "
        f"peak allocated {out['load']['peak_allocated_bytes'] / 2**30:.2f} GiB")
    out["graph_equals_eager"] = {}
    for kv in ("model", "int8"):
        eng = TorchEngine(TorchEngineConfig(
            model=mcfg, num_blocks=GPTOSS_BLOCKS, block_size=BS, max_batch_size=8,
            max_context=8192, kv_dtype=kv, decode_steps=HZ_STEPS, decode_pipeline=1),
            params=params)
        tag = f"gpt-oss-20b {'int8' if kv == 'int8' else 'bf16'}"
        r = {**graph_equals_eager(torch, eng, tag, [300, 5000, 2500, 8192 - HZ_STEPS, 64, 0,
                                                    4500, 17]), **horizon_report(eng)}
        out["graph_equals_eager"][tag] = r
        log(f"horizon graph = eager, {tag}: bit-identical over {r['steps']} steps at key "
            f"{r['key']} ({r['pages_compared']} pages x {r['cache_arrays']} cache arrays); "
            f"eager {r['eager_s'] * 1e3:.1f} ms, replay {r['replay_s'] * 1e3:.1f} ms; graphs "
            f"{r['horizon']}")
        eng.stop()
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    # the horizon schedules stream one-step decode's tokens
    prompts = horizon_prompts()
    runs = {}
    for tag, knobs in (("a", dict(decode_steps=1, decode_pipeline=1)), ("d", {})):
        run, eng = asyncio.run(serve_decode_heavy(
            torch, params, prompts, mcfg=mcfg, tokens=GPTOSS_HZ_TOKENS, max_context=8192,
            **knobs))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        runs[tag] = run
        log(f"gpt-oss decode-heavy ({tag}) on {smi}: schedule {run['schedule']}; "
            f"{run['output_tok_s']:.1f} tok/s, ITL median {run['itl_s_median'] * 1e3:.2f} ms, "
            f"TTFT median {run['ttft_s_median'] * 1e3:.0f} ms; steps {run['steps']}; graphs "
            f"{run['horizon']}")
    for r in runs["a"]["requests"]:
        if len(r["tokens"]) != GPTOSS_HZ_TOKENS or r["finish"] != "length":
            raise AssertionError(f"gpt-oss decode-heavy (a): request {r['i']}: "
                                 f"{len(r['tokens'])} tokens, {r['finish']!r}")
    check_same_streams("gpt-oss decode-heavy (d)", runs["d"], runs["a"], None)
    if runs["d"]["horizon"]["replays"] <= 0:
        raise AssertionError(f"gpt-oss decode-heavy (d): no graph replay: {runs['d']}")
    # (d) again under the profiler: where a graphed decode step's time goes
    prof, eng = asyncio.run(serve_decode_heavy(
        torch, params, prompts, profile=True, mcfg=mcfg, tokens=GPTOSS_HZ_TOKENS,
        max_context=8192))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    prof["busy_share"] = prof["device_busy_ms"] / (runs["d"]["wall_s"] * 1e3)
    passes = prof["steps"]["horizon"] * prof["schedule"]["decode_steps"] + sum(
        prof["steps"][k] for k in ("prefill", "decode", "mixed"))
    # the form the horizon's graphs captured: torch._grouped_mm's kernels
    if prof["device_ms"]["grouped_gemm"] <= 0:
        raise AssertionError("gpt-oss decode-heavy (d): no grouped GEMM kernel ran in the "
                             f"profiled horizons: {prof['device_ms']}")
    out["experts"]["captured"] = "grouped (torch._grouped_mm)"
    log(f"gpt-oss decode-heavy (d) profiled on {smi}: device busy "
        f"{prof['device_busy_ms']:.1f} ms, {prof['busy_share']:.1%} of the unprofiled (d) "
        f"wall; {prof['device_ms']['kernels']} kernels over {passes} forward passes "
        f"({prof['device_ms']['kernels'] / passes:.0f} each), "
        f"{prof['device_busy_ms'] / passes:.3f} device ms each; device ms "
        + json.dumps(prof["device_ms"]))
    runs["d profiled"] = prof
    out["schedules"] = {t: {k: v for k, v in r.items() if k != "requests"}
                        for t, r in runs.items()}
    # the serving runs: bf16, profiled again, then a short int8 run
    serving = {}
    for key, int8, profile in (("bf16", False, False), ("bf16 profiled", False, True),
                               ("int8", True, False)):
        run = asyncio.run(serve_windowed(
            torch, mcfg, "gpt-oss-20b", GPTOSS_INT8_PROMPTS if int8 else GPTOSS_PROMPTS,
            16 if int8 else 32, int8=int8, profile=profile, params=params, prompt_seed=12,
            sample_seed=13))
        serving[key] = run
        log(f"serving gpt-oss-20b {key}: " + json.dumps(run))
        gc.collect()
        torch.cuda.empty_cache()
    run, prof = serving["bf16"], serving["bf16 profiled"]
    prof["busy_share"] = prof["device_busy_ms"] / (run["wall_s"] * 1e3)
    log(f"serving gpt-oss-20b on {smi}: {run['requests']} requests of {GPTOSS_PROMPTS} "
        f"tokens, {run['output_tok_s']:.1f} output tok/s, TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), ITL median "
        f"{run['itl_s_median'] * 1e3:.2f} ms (max {run['itl_s_max'] * 1e3:.2f}); device busy "
        f"{prof['busy_share']:.1%} ({prof['device_busy_ms']:.1f} ms profiled); graphs "
        f"{run['horizon']}; launches {run['launches']}; peak allocated "
        f"{run['peak_allocated_bytes'] / 2**30:.2f} GiB; int8: "
        f"{serving['int8']['output_tok_s']:.1f} tok/s, ITL median "
        f"{serving['int8']['itl_s_median'] * 1e3:.2f} ms")
    out["serving"] = serving
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return results, out


# ------------------------------------------------------------- phase 7
# DeepSeek-V2-Lite's latent attention: 16 query heads over one kv head of
# 576 lanes (kv_lora_rank 512 + qk_rope_head_dim 64), 512 value lanes;
# V2 / V3 have 128 query heads
LD, LV = 576, 512
LATENT_DECODE_LENS = (1, 2000, 3000, 4000, 5000, 6000, 7000, 8000)
# case -> (query heads, rows [(q_len, seq_len)])
LATENT_CASES = {
    "decode G=16": (16, [(1, n) for n in LATENT_DECODE_LENS]),
    "decode G=128": (128, [(1, n) for n in LATENT_DECODE_LENS]),
    # the last 2048-token chunk of a 6000-token prompt
    "prefill chunk": (16, [(2048, 6000)]),
    # one chunk row and 8 decode rows in one launch
    "mixed": (16, [(1024, 2500)] + [(1, n) for n in (130, 700, 1500, 3000, 4500, 6000,
                                                      7000, 8000)]),
    # rows of 1-2 tokens (split at G = 16 when a launch's q_len bound is
    # 2) whose last 256-key split holds keys their first token never sees
    "short rows": (16, [(2, 513), (2, 1025), (1, 700), (2, 3000), (2, 257), (1, 1),
                        (2, 2049)]),
}
# the cases whose split-K must reach the SM count in working blocks
LATENT_FILL = ("decode G=16", "decode G=128")
LATENT_SPLIT_ROWS = "short rows"
LATENT_MUTANT_CASE = "decode G=16"


def latent_library_call(torch, q, kc, vc, tables, starts, rows):
    """One PyTorch call computing the same function as a latent case:
    scaled_dot_product_attention over the gathered latent, each row's h
    heads folded into the query axis (one kv head serves them all, so
    nothing is expanded), keys padded to a multiple of 16 with a boolean
    causal mask; PyTorch picks the backend that takes d = 576 (padding
    query rows see key 0). Returns (call, packed [Tq, h, 512] output of a
    call's result)."""
    from dynamo_tpu_torch.ops import attention as att

    dev = q.device
    R, h = len(rows), q.shape[1]
    T, max_q = max(sl for _, sl in rows), max(ql for ql, _ in rows)
    Tp = -(-T // 16) * 16
    qp = torch.zeros(R, 1, max_q * h, LD, dtype=torch.bfloat16, device=dev)
    kp = torch.zeros(R, 1, Tp, LD, dtype=torch.bfloat16, device=dev)
    vp = torch.zeros(R, 1, Tp, LV, dtype=torch.bfloat16, device=dev)
    for r, (ql, sl) in enumerate(rows):
        k, v = att.gather_kv(kc, vc, tables[r])
        kp[r, 0, :sl], vp[r, 0, :sl] = k[:sl, 0], v[:sl, 0, :LV]
        qp[r, 0, :ql * h] = q[starts[r]:starts[r] + ql].reshape(ql * h, LD)
    i64 = dict(dtype=torch.long, device=dev)
    q_len = torch.tensor([ql for ql, _ in rows], **i64)[:, None, None]
    q_off = torch.tensor([sl - ql for ql, sl in rows], **i64)[:, None, None]
    tok = (torch.arange(max_q * h, device=dev) // h)[None, :, None]
    key = torch.arange(Tp, device=dev)[None, None, :]
    mask = torch.where(tok < q_len, key <= q_off + tok, key == 0)[:, None]

    def unpack(out):
        packed = torch.zeros(q.shape[0], h, LV, dtype=torch.bfloat16, device=dev)
        for r, (ql, _) in enumerate(rows):
            packed[starts[r]:starts[r] + ql] = out[r, 0, :ql * h].reshape(ql, h, LV)
        return packed

    sdpa = torch.nn.functional.scaled_dot_product_attention
    return (lambda: sdpa(qp, kp, vp, attn_mask=mask)), unpack


def latent_case(torch, gen, timer, name, h, rows):
    """One latent kernel case: against its plain version and its plain
    split form, the split counts the kernel wrote held to att.split_plan,
    timed with its bound and its library yardstick."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_mla

    i32 = dict(dtype=torch.int32, device="cuda")
    lens = [sl for _, sl in rows]
    kc, vc, tables = paged_case(torch, gen, lens, num_blocks=sum(-(-n // BS) for n in lens)
                                + 64, kvh=1, d=LD)
    starts, pos = [], 0
    for ql, _ in rows:
        starts.append(pos)
        pos += ql + 5
    q = torch.randn(pos, h, LD, generator=gen, device="cuda").to(torch.bfloat16)
    args = (q, kc, vc, tables, torch.tensor(starts, **i32),
            torch.tensor([ql for ql, _ in rows], **i32), torch.tensor(lens, **i32))
    max_q, max_s = max(ql for ql, _ in rows), max(lens)
    bounds = dict(max_q_len=max_q, max_seq_len=max_s)
    tag = f"latent {name}"
    cuda_mla.split_log = []
    try:
        got = cuda_mla.latent_paged_attention(*args, **bounds)
        (grid, n_dev), = cuda_mla.split_log
    finally:
        cuda_mla.split_log = None
    plain = att.ragged_paged_attention(*args)[..., :LV]
    err = compare(torch, got, plain, tag)
    compare(torch, got, cuda_mla.split_latent_attention(*args, **bounds), tag + " (plain split)")
    _, tile_rows, qs, _ = cuda_mla.tile_shape(h, max_q)
    S = cuda_mla.split_extent(max_s)
    n_kernel = n_dev.tolist()
    n_plain = [att.split_plan(ql, sl, 0, cuda_mla.SPLIT_KEYS, BS, S)[2]
               if S > 1 and 0 < ql <= qs else 0 for ql, sl in rows]
    if n_kernel != n_plain:
        raise AssertionError(f"{tag}: the kernel split its rows {n_kernel}, the plain split "
                             f"plan {n_plain}")
    blocks = sum(max(n, 1) * -(-ql * h // tile_rows) for (ql, _), n in zip(rows, n_kernel))
    out = {"h": h, "rows": rows, "max_abs_err": err, "grid": grid, "splits_per_row": n_kernel,
           "working_blocks": blocks}
    if name == LATENT_SPLIT_ROWS:
        _, _, l, n = att.attention_partials(
            *args, split_keys=cuda_mla.SPLIT_KEYS, align=BS, max_splits=S, tile_tokens=qs)
        out["tokens_missing_a_split"] = sum(
            int((l[r, :c, :ql] == 0).all(-1).sum())
            for r, (c, (ql, _)) in enumerate(zip(n.tolist(), rows)) if c)
        if not out["tokens_missing_a_split"]:
            raise AssertionError(f"{tag}: no token misses a whole split")
    if name == LATENT_MUTANT_CASE:
        wrong = cuda_mla.split_latent_attention(*args, **bounds, drop_last_split=True)
        try:
            compare(torch, got, wrong, tag + " against its drop-last-split mutant")
        except AssertionError:
            out["drop_last_split_mutant_fails"] = True
        else:
            raise AssertionError(f"{tag}: a merge without each row's last split passes")
        del wrong
    live = [(ql, sl) for ql, sl in rows if ql > 0 and sl > 0]
    pages = sum(-(-sl // BS) for _, sl in live)
    tokens = sum(ql for ql, _ in live)
    b, by = bound(2 * tokens * h * (LD + LV)            # queries in, outputs out
                  + pages * BS * 2 * (LD + LV)           # K pages at 576 lanes, V at 512
                  + 4 * (3 * len(rows) + pages),
                  2 * sum(visible_pairs(ql, sl, 0) for ql, sl in live) * h * (LD + LV))
    library, unpack = latent_library_call(torch, q, kc, vc, tables, starts, rows)
    lib_err = (unpack(library()).float() - plain.float()).abs().max().item()
    ms = timer(lambda: cuda_mla.latent_paged_attention(*args, **bounds))
    out.update(
        ms=ms, plain_ms=timer(lambda: att.ragged_paged_attention(*args), reps=3),
        library_ms=timer(library), library="scaled_dot_product_attention (heads folded "
        "into the query axis; PyTorch's backend choice at d 576)", library_max_abs_err=lib_err,
        bound_ms=b, bound_by=by, achieved_of_bound=b / ms)
    del library, unpack
    log(f"  {tag}: max abs err {err:.3g}; {ms:.4f} ms kernel, {out['plain_ms']:.4f} ms plain, "
        f"{out['library_ms']:.4f} ms library (max abs err {lib_err:.3g}), bound {b:.4f} ms "
        f"({by}, {b / ms:.1%} of it reached); grid {grid}, splits per row {n_kernel} (the "
        f"kernel's count), {blocks} working blocks"
        + (f"; {out['tokens_missing_a_split']} (row, split, token) triples whose split holds "
           "no key the token sees" if "tokens_missing_a_split" in out else "")
        + ("; the plain merge without each row's last split fails the compare"
           if name == LATENT_MUTANT_CASE else ""))
    return out


def latent_build_report(_build) -> dict:
    """The latent kernel's build: registers and spills per entry (fails on
    a spill) and blocks per SM with their dynamic shared memory
    (dtt_latent_occupancy)."""
    import ctypes
    import re

    with open(os.path.join(_build.build_dir(), "libmla_attention.so.log")) as f:
        lines = ptxas_summary(f.read())
    spills = [l for l in lines if re.search(r"[1-9]\d* bytes spill", l)]
    if not lines or spills:
        raise AssertionError(f"latent kernel: spills or no ptxas report: {lines}")
    fn = _build.load("mla_attention.cu").dtt_latent_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    occ = {}
    for mt in (1, 2):
        blocks, smem = ctypes.c_int(), ctypes.c_int()
        err = fn(mt, ctypes.byref(blocks), ctypes.byref(smem))
        if err or blocks.value < 1:
            raise AssertionError(f"latent kernel MT={mt}: occupancy {blocks.value}, error {err}")
        occ[f"MT={mt}"] = {"blocks_per_sm": blocks.value, "smem_bytes": smem.value}
    log("latent kernel build: " + " | ".join(lines) + f"; blocks per SM {occ}")
    return {"ptxas": lines, "occupancy": occ}


def check_latent(torch, gen, timer, _build):
    build = latent_build_report(_build)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cases = {name: latent_case(torch, gen, timer, name, h, rows)
             for name, (h, rows) in LATENT_CASES.items()}
    for name in LATENT_FILL:
        if cases[name]["working_blocks"] < sms:
            raise AssertionError(f"latent {name}: {cases[name]['working_blocks']} working "
                                 f"blocks on {sms} SMs")
    main = cases["decode G=16"]
    return {
        "name": "latent_paged_attention", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/mla_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "shape": f"kvh=1 d_qk={LD} d_v={LV} bs={BS} bf16; top-level numbers: the "
                 f"'decode G=16' case (DeepSeek-V2-Lite), rows (q_len, seq_len) "
                 f"{main['rows']}; every case under 'cases'",
        **{k: main[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")},
        "build": build, "cases": cases,
    }


def shared_f32(p, x):
    """DeepSeek's shared experts in float32 (the plain version's)."""
    import torch.nn.functional as F

    xf = x.float()
    gate = F.silu(xf @ p["w_shared_gate"].float())
    return (gate * (xf @ p["w_shared_up"].float())) @ p["w_shared_down"].float()


def check_moe_experts(torch, gen, timer) -> dict:
    """The routed-expert FFN of Qwen3-30B-A3B (128 experts, top 8) and of a
    DeepSeek-V2-Lite MoE layer (64, top 6, 2 shared experts) at full
    width, as the engine runs it (routing, grouped products, slot sum; and
    DeepSeek's shared experts), against the float32 expert loop per token
    row at EXPERT_TOKENS tokens, timed against its byte and FLOP bounds
    (no single PyTorch call computes it); then its decode-batch form
    captured into a CUDA graph must replay its eager run bit for bit."""
    from dynamo_tpu_torch.models import mla, moe

    qwen = moe.MoeConfig.qwen3_30b_a3b()
    lite = mla.MlaConfig.deepseek_v2_lite()
    pq = moe.init_layer_params(qwen, gen, "cuda")
    pl = mla.init_layer_params(lite, gen, "cuda", lite.first_dense_layers)
    el = mla.expert_params(pl)
    forms = {
        "qwen3-30b-a3b": (
            qwen, lambda x: moe.experts_grouped(pq, qwen, x, moe.route(pq, qwen, x)),
            lambda x: moe.experts_plain(pq, qwen, x, moe.route(pq, qwen, x)).float(),
            lambda x: moe.route(pq, qwen, x)[1], 0),
        "deepseek-v2-lite": (
            lite, lambda x: mla.moe_ffn(pl, lite, x),
            lambda x: moe.experts_plain(el, lite, x, mla.route(pl, lite, x)).float()
            + shared_f32(pl, x),
            lambda x: mla.route(pl, lite, x)[1],
            lite.moe_intermediate_size * lite.num_shared_experts),
    }
    out = {}
    for tag, (cfg, fn, plain_fn, ids_fn, shared) in forms.items():
        H, I, K, E = (cfg.hidden_size, cfg.moe_intermediate_size, cfg.num_experts_per_tok,
                      cfg.num_experts)
        out[tag] = {}
        for T in EXPERT_TOKENS:
            x = torch.randn(T, H, generator=gen, device="cuda").to(torch.bfloat16)
            got, want = fn(x), plain_fn(x)
            row_rel = ((got.float() - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
            if not torch.isfinite(got).all() or row_rel > KERNEL_ROW_REL:
                raise AssertionError(f"{tag} experts T={T}: rows differ from the float32 "
                                     f"loop by {row_rel:.4g} relative L2 (limit "
                                     f"{KERNEL_ROW_REL})")
            hit = len(set(ids_fn(x).flatten().tolist()))
            b, by = bound(2 * (hit * 3 * H * I + 3 * H * shared + H * E) + 2 * 2 * T * H,
                          2 * T * (K * 3 * H * I + 3 * H * shared + H * E))
            ms = timer(lambda: fn(x), busy=2_000_000)
            out[tag][T] = {"max_abs_err": (got.float() - want).abs().max().item(),
                           "worst_row_rel": row_rel, "experts_hit": hit, "ms": ms,
                           "plain_ms": timer(lambda: plain_fn(x), reps=3),
                           "library_ms": None, "bound_ms": b, "bound_by": by}
            log(f"  {tag} experts T={T}: worst row relative L2 {row_rel:.3g} (limit "
                f"{KERNEL_ROW_REL}) against the float32 loop; {ms:.4f} ms, "
                f"{out[tag][T]['plain_ms']:.4f} ms plain, bound {b:.4f} ms ({by}, {hit} of {E} "
                f"experts hit)")
        x = torch.randn(EXPERT_TOKENS[0], H, generator=gen, device="cuda").to(torch.bfloat16)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = fn(x)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            y = fn(x)
        graph.replay()
        torch.cuda.synchronize()
        if not torch.equal(y, eager):
            raise AssertionError(f"{tag} experts: the graph replay differs from the eager run")
        out[tag]["graph_equals_eager"] = True
        del graph
    return out


def latent_attention_paths(torch, table, mutants, qk_head_dim):
    """The latent model check's attention paths (as attention_paths): the
    latent kernel for the prefill chunk, the decode steps and the ragged
    step (each one ragged row), the plain op cut to 512 lanes, and two
    wrong attentions: the query's MLA pre-scale dropped (logits 1 /
    sqrt(576 / ``qk_head_dim``) too small) and k_pe zeroed in the cache."""
    import math

    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_mla

    i32 = dict(dtype=torch.int32, device=table.device)

    def one(n):
        return torch.tensor([n], **i32)

    def rows(q, total):
        return table[None], one(0), one(q.shape[0]), one(total)

    def kernel(q, kc, vc, total):
        return cuda_mla.latent_paged_attention(q, kc, vc, *rows(q, total),
                                               max_q_len=q.shape[0], max_seq_len=total)

    def plain(q, kc, vc, total):
        return att.ragged_paged_attention(q, kc, vc, *rows(q, total))[..., :LV]

    def no_prescale(q, kc, vc, total):
        return plain((q.float() / math.sqrt(LD / qk_head_dim)).to(q.dtype), kc, vc, total)

    def no_k_pe(q, kc, vc, total):
        kz = kc.clone()
        kz[..., LV:] = 0
        return plain(q, kz, vc, total)

    paths = {"kernels": (kernel,) * 3, "plain": (plain,) * 3,
             "mutant: query pre-scale dropped": (no_prescale,) * 3,
             "mutant: k_pe zeroed in the cache": (no_k_pe,) * 3}
    return {k: v for k, v in paths.items() if not k.startswith("mutant") or k in mutants}


LATENT_MUTANTS = ("mutant: query pre-scale dropped", "mutant: k_pe zeroed in the cache")
# (layers, prompt tokens) of each model check: DeepSeek-V2-Lite over a
# long prompt; Qwen3-30B-A3B over the llama check's 300 tokens, the length
# its mutants read at (one key dropped of 1500 moves the logits by ~0.02)
MOE_MODEL_CHECKS = {"deepseek-v2-lite": (2, 1500), "qwen3-30b-a3b": (2, 300)}
# the router bias that pins each MoE layer's top k in the DeepSeek check:
# softmax scores lie in [0, 1], so a bias of 2 on k experts fixes the
# selection (a token whose k-th and (k+1)-th scores lie within the paths'
# bf16 rounding would take other experts on each path, a jump of the
# function that is no kernel's error); the combine weights stay the
# unbiased scores
LATENT_ROUTER_PIN = 2.0


def pin_latent_router(cfg, params, rng):
    import torch

    for lp in params["layers"]:
        if "w_router" in lp:
            bias = torch.zeros(cfg.num_experts, dtype=torch.float32,
                               device=lp["w_router"].device)
            bias[rng.permutation(cfg.num_experts)[:cfg.num_experts_per_tok].tolist()] = (
                LATENT_ROUTER_PIN)
            lp["router_bias"] = bias


def pin_moe_router(cfg, params, rng):
    """Qwen3-MoE's router has no bias: a zero router gives every token
    equal scores, and the tie rule (lowest ids) the same experts on both
    paths."""
    for lp in params["layers"]:
        lp["w_router"].zero_()


def moe_mla_model_checks(torch) -> dict:
    """model_check for DeepSeek-V2-Lite and Qwen3-30B-A3B at full width, cut
    to MOE_MODEL_CHECKS' layers (V2-Lite: one dense layer, one MoE layer),
    routing pinned; the kernel path (latent kernel, or kernels 1-3; the
    grouped experts) against the plain path (plain attention, the float32
    expert loop), with the latent mutants and the llama mutants."""
    from dynamo_tpu_torch.models import mla, moe

    out = {}
    lite = mla.MlaConfig.deepseek_v2_lite()
    for tag, base, weight_sets, paths in (
            ("deepseek-v2-lite", lite, [(pin_latent_router, LATENT_MUTANTS)],
             lambda t, m: latent_attention_paths(torch, t, m, lite.qk_head_dim)),
            ("qwen3-30b-a3b", moe.MoeConfig.qwen3_30b_a3b(), [(pin_moe_router, MODEL_MUTANTS)],
             lambda t, m: attention_paths(torch, t))):
        layers, prompt_len = MOE_MODEL_CHECKS[tag]
        cfg = dataclasses.replace(base, num_layers=layers)
        t0 = time.perf_counter()
        worst, mutants, spread = model_check(torch, f"model {tag} x{layers} layers", cfg,
                                             prompt_len, 400, weight_sets, paths)
        out[tag] = {"worst": worst, "mutants": mutants, "max_logit": spread}
        log(f"model {tag}: {layers} layers at full width, prefill {prompt_len} + 3 decode + a "
            f"2-token ragged step, {len(MODEL_SEEDS)} seeds: kernels vs plain logits relative "
            f"L2 {worst:.4g} at worst (limit {MODEL_REL_TOL}); mutants at least "
            + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
            + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    return out


LATENT_PROMPTS = (100, 700, 1500, 2600, 3300, 4100, 5000, 6000)
# Qwen3-30B-A3B (61 GB at 48 layers) is served at 12 layers, full width:
# its attention path is kernels 1-3 at llama's shape, served at full depth
# on llama3-8b, and its expert path is checked alone at full width. 64
# tokens a request: at 12 layers a request decodes 32 tokens in less than
# the 0.25 s to the next arrival, and kernel 3 (the mixed step) would run
# only when the arrivals happen to overlap
QWEN_SERVE_LAYERS = 12
QWEN_SERVE_TOKENS = 64
LATENT_FORBID = ("decode", "flash_extend", "unified", "decode_int8", "flash_extend_int8",
                 "unified_int8")


def moe_mla_phase(torch, gen, smi: str, _build) -> tuple:
    """DeepSeek-V2-Lite and Qwen3-30B-A3B on the card (module docstring,
    phase 7). Returns (the kernel results by report name, the phase's
    report)."""
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig, param_bytes
    from dynamo_tpu_torch.models import mla, moe, registry
    from dynamo_tpu_torch.ops import cuda_mla

    results, out = {}, {}
    timer = Timer(torch)
    t0 = time.perf_counter()
    r = check_latent(torch, gen, timer, _build)
    results[r["name"]] = r
    log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} over {len(r['cases'])} cases "
        f"(atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL}) "
        f"[{time.perf_counter() - t0:.1f} s]")
    t0 = time.perf_counter()
    out["experts"] = check_moe_experts(torch, gen, timer)
    log(f"experts on {smi}: " + json.dumps(out["experts"]) +
        f" [{time.perf_counter() - t0:.1f} s]")
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    out["model"] = moe_mla_model_checks(torch)

    errors = ErrorLog()
    # DeepSeek-V2-Lite at all 27 layers on its defaults
    mcfg = mla.MlaConfig.deepseek_v2_lite()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    out["load"] = {"s": time.perf_counter() - t0, "param_bytes": param_bytes(params)}
    log(f"deepseek-v2-lite: {mcfg.num_layers} layers, random bf16 weights (seed 0), "
        f"{out['load']['param_bytes'] / 1e9:.2f} GB, loaded in {out['load']['s']:.1f} s")
    eng = TorchEngine(TorchEngineConfig(
        model=mcfg, num_blocks=GPTOSS_BLOCKS, block_size=BS, max_batch_size=8,
        max_context=8192, decode_steps=HZ_STEPS, decode_pipeline=1), params=params)
    r = {**graph_equals_eager(torch, eng, "deepseek-v2-lite", [300, 5000, 2500,
                                                               8192 - HZ_STEPS, 64, 0, 4500,
                                                               17]), **horizon_report(eng)}
    out["graph_equals_eager"] = r
    log(f"horizon graph = eager, deepseek-v2-lite bf16: bit-identical over {r['steps']} steps "
        f"at key {r['key']} ({r['pages_compared']} pages x {r['cache_arrays']} cache arrays); "
        f"eager {r['eager_s'] * 1e3:.1f} ms, replay {r['replay_s'] * 1e3:.1f} ms; graphs "
        f"{r['horizon']}")
    eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    # the serving run, then again under the profiler
    serving = {}
    for key, profile in (("bf16", False), ("bf16 profiled", True)):
        run = asyncio.run(serve_windowed(
            torch, mcfg, "deepseek-v2-lite", LATENT_PROMPTS, 32, profile=profile,
            params=params, prompt_seed=14, sample_seed=15, expect=("latent",),
            forbid=LATENT_FORBID, split_module=cuda_mla))
        serving[key] = run
        log(f"serving deepseek-v2-lite {key}: " + json.dumps(run))
        gc.collect()
        torch.cuda.empty_cache()
    run, prof = serving["bf16"], serving["bf16 profiled"]
    prof["busy_share"] = prof["device_busy_ms"] / (run["wall_s"] * 1e3)
    if run["launches"]["replayed"]["latent"] <= 0:
        raise AssertionError(f"deepseek-v2-lite: no latent launch through a graph replay: "
                             f"{run['launches']}")
    log(f"serving deepseek-v2-lite on {smi}: {run['requests']} requests of {LATENT_PROMPTS} "
        f"tokens, {run['output_tok_s']:.1f} output tok/s, TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), ITL median "
        f"{run['itl_s_median'] * 1e3:.2f} ms (max {run['itl_s_max'] * 1e3:.2f}); device busy "
        f"{prof['busy_share']:.1%} ({prof['device_busy_ms']:.1f} ms profiled); device ms "
        f"{json.dumps(prof['device_ms'])}; graphs {run['horizon']}; launches {run['launches']}; "
        f"peak allocated {run['peak_allocated_bytes'] / 2**30:.2f} GiB")
    out["serving"] = serving
    # decode-heavy traffic: one eager step per tick, and the auto-tuned
    # graphed schedule (profiled again)
    prompts = horizon_prompts()
    runs = {}
    for tag, knobs, profile in (("a", dict(decode_steps=1, decode_pipeline=1), False),
                                ("d", {}, False), ("d profiled", {}, True)):
        run, eng = asyncio.run(serve_decode_heavy(
            torch, params, prompts, profile=profile, mcfg=mcfg, tokens=GPTOSS_HZ_TOKENS,
            max_context=8192, **knobs))
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        runs[tag] = run
        log(f"deepseek-v2-lite decode-heavy ({tag}) on {smi}: schedule {run['schedule']}; "
            f"{run['output_tok_s']:.1f} tok/s, ITL median {run['itl_s_median'] * 1e3:.2f} ms, "
            f"TTFT median {run['ttft_s_median'] * 1e3:.0f} ms; steps {run['steps']}; graphs "
            f"{run['horizon']}; launches {run['launches']}")
    for rq in runs["a"]["requests"]:
        if len(rq["tokens"]) != GPTOSS_HZ_TOKENS or rq["finish"] != "length":
            raise AssertionError(f"deepseek-v2-lite decode-heavy (a): request {rq['i']}: "
                                 f"{len(rq['tokens'])} tokens, {rq['finish']!r}")
    check_same_streams("deepseek-v2-lite decode-heavy (d)", runs["d"], runs["a"], None)
    if runs["d"]["launches"]["replayed"]["latent"] <= 0:
        raise AssertionError(f"deepseek-v2-lite decode-heavy (d): no latent launch through a "
                             f"graph replay: {runs['d']['launches']}")
    prof = runs["d profiled"]
    prof["busy_share"] = prof["device_busy_ms"] / (runs["d"]["wall_s"] * 1e3)
    passes = prof["steps"]["horizon"] * prof["schedule"]["decode_steps"] + sum(
        prof["steps"][k] for k in ("prefill", "decode", "mixed"))
    log(f"deepseek-v2-lite decode-heavy (d) profiled on {smi}: device busy "
        f"{prof['device_busy_ms']:.1f} ms, {prof['busy_share']:.1%} of the unprofiled (d) wall; "
        f"{prof['device_busy_ms'] / passes:.3f} device ms per forward pass; device ms "
        + json.dumps(prof["device_ms"]))
    out["schedules"] = {t: {k: v for k, v in r.items() if k != "requests"}
                        for t, r in runs.items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # Qwen3-30B-A3B at QWEN_SERVE_LAYERS layers: kernels 1-3 and the experts
    qcfg = dataclasses.replace(moe.MoeConfig.qwen3_30b_a3b(), num_layers=QWEN_SERVE_LAYERS)
    run = asyncio.run(serve_windowed(
        torch, qcfg, "qwen3-30b-a3b", LATENT_PROMPTS, QWEN_SERVE_TOKENS, prompt_seed=16,
        sample_seed=17, expect=("decode", "flash_extend", "unified"), forbid=("latent",)))
    log(f"serving qwen3-30b-a3b x{QWEN_SERVE_LAYERS} layers on {smi}: " + json.dumps(run))
    log(f"serving qwen3-30b-a3b ({QWEN_SERVE_LAYERS} of its 48 layers, full width) on {smi}: "
        f"{run['output_tok_s']:.1f} output tok/s, TTFT median "
        f"{run['ttft_s_median'] * 1e3:.0f} ms, ITL median {run['itl_s_median'] * 1e3:.2f} ms; "
        f"schedule {run['schedule']}; peak allocated "
        f"{run['peak_allocated_bytes'] / 2**30:.2f} GiB")
    out["qwen_serving"] = run
    errors.close()
    if errors.records:
        raise AssertionError(f"ERROR log records: {[r.getMessage() for r in errors.records]}")
    gc.collect()
    torch.cuda.empty_cache()
    return results, out


# ------------------------------------------------------------------ main
PHASES = ("kernels", "model", "serve", "horizon", "gptoss", "moe_mla")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of " + ",".join(PHASES) + " (environment and build "
                         "always run; the report needs them all)")
    args = ap.parse_args()
    phases = set(args.phases.split(","))

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        from dynamo_tpu_torch.ops import _build
    except ImportError as e:
        print(f"chip_smoke: the dynamo_tpu_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment + build
    smi = nvidia_smi_line()
    log(f"card: {smi}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    out_dir = _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> {out_dir}")
    for name in sorted(os.listdir(out_dir)):
        if name.endswith(".log"):
            with open(os.path.join(out_dir, name)) as f:
                log(f"  {name[:-4]}: " + " | ".join(ptxas_summary(f.read())))
    tensor_core_instructions(out_dir)
    log("unified kernel, blocks per SM by the occupancy calculator (dynamic shared memory): "
        + ", ".join(f"d={d} {'int8' if i8 else 'bf16'} {b} ({smem} B)"
                    for d, i8, b, smem in unified_occupancy(_build)))

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    flex = None
    if phases & {"kernels", "gptoss"}:
        from torch.nn.attention.flex_attention import flex_attention

        # the yardstick of the softcap and gpt-oss sink cases: one compile
        # per case and form
        torch._dynamo.config.recompile_limit = 64
        flex = torch.compile(flex_attention, fullgraph=True)
    t_start = time.perf_counter()
    if "kernels" in phases:
        for check, int8 in ((check_decode, False), (check_flash, False),
                            (check_unified, False), (check_decode, True),
                            (check_flash, True), (check_unified, True)):
            t0 = time.perf_counter()
            r = check(torch, gen, timer, int8=int8)
            results[r["name"]] = r
            log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} "
                f"(atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL}); "
                f"{r['ms']:.4f} ms kernel, "
                f"{r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms library, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                f"[{time.perf_counter() - t0:.1f} s]")
        for int8 in (False, True):
            t0 = time.perf_counter()
            r = check_unified_attrs(torch, gen, timer, GEMMA, int8=int8, flex=flex)
            results[r["name"]] = r
            log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} over "
                f"{len(r['cases'])} cases (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row "
                f"{KERNEL_ROW_REL}) [{time.perf_counter() - t0:.1f} s]")
        r = check_merge(torch, gen, timer, GEMMA)
        results[r["name"]] = r
        log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} (atol {KERNEL_ATOL}, "
            f"rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL}); {r['ms']:.4f} ms kernel, "
            f"{r['plain_ms']:.4f} ms plain, bound {r['bound_ms']:.4f} ms ({r['bound_by']}); "
            "the sink counted once per split moves the split rows by "
            f"{r['sink_per_split_row_gap'][0]:.3g}-{r['sink_per_split_row_gap'][1]:.3g} "
            "(relative L2) and fails the compare")
        worst = check_group_sizes(torch, gen)
        log(f"kernels at 1, 2 and 8 query heads per kv head, bf16 and int8: max abs "
            f"err {worst:.3g} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL})")
        t0 = time.perf_counter()
        for r in check_block_copy(torch, gen, timer):
            results[r["name"]] = r
            log(f"kernel {r['name']}: bit-exact at M={list(COPY_MS)}; {r['ms']:.4f} ms "
                f"kernel, {r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms library "
                f"({r['library']}), bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"bf16 pages {r['bf16_ms']:.4f} ms")
        for r in check_layer_moves(torch, gen, timer):
            results[r["name"]] = r
        log(f"block copy checks [{time.perf_counter() - t0:.1f} s]")
        writes = time_kv_writes(torch, gen, timer)
        log(f"decode KV write of one layer, 8 rows (plain PyTorch): "
            f"{writes['bf16_ms']:.4f} ms bf16, {writes['int8_ms']:.4f} ms int8")
    del timer
    torch.cuda.empty_cache()
    log(f"kernels phase [{time.perf_counter() - t_start:.1f} s]")
    t_phase = time.perf_counter()
    if "model" in phases:
        from dynamo_tpu_torch.models.llama import LlamaConfig

        for int8 in (False, True):
            t0 = time.perf_counter()
            cfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=2)
            worst, mutants, spread = model_check(
                torch, "model int8" if int8 else "model", cfg, 300, 100,
                [(None, MODEL_MUTANTS)], lambda t, _: attention_paths(torch, t, int8), int8)
            log(f"model{' int8' if int8 else ''}: 2-layer llama3-8b width, prefill 300 + "
                f"3 decode + a 2-token ragged step, {len(MODEL_SEEDS)} seeds: kernels vs "
                f"plain logits relative L2 {worst:.4g} at worst (limit {MODEL_REL_TOL}); "
                "mutants at least "
                + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
                + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
        for preset, layers, prompt_len in GEMMA_MODEL_CHECKS:
            t0 = time.perf_counter()
            worst, mutants, spread = gemma_model_check(torch, preset, layers, prompt_len)
            log(f"model {preset}: {layers} layers at full width, prefill {prompt_len} + 3 "
                f"decode + a 2-token ragged step, {len(MODEL_SEEDS)} seeds: kernels vs plain "
                f"logits relative L2 {worst:.4g} at worst (limit {MODEL_REL_TOL}); mutants "
                "at least " + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
                + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
            gc.collect()
            torch.cuda.empty_cache()
    log(f"model phase [{time.perf_counter() - t_phase:.1f} s]")
    t_phase = time.perf_counter()
    serving = None
    if "serve" in phases:
        serving = asyncio.run(serve(torch))
        log("serving: " + json.dumps(serving))
        log(f"serving on {smi}: {serving['requests']} requests, "
            f"{serving['output_tok_s']:.1f} output tok/s, TTFT median "
            f"{serving['ttft_s_median'] * 1e3:.0f} ms, ITL median "
            f"{serving['itl_s_median'] * 1e3:.1f} ms")
        gc.collect()
        torch.cuda.empty_cache()
        # the same traffic again on a fresh engine under torch.profiler
        # (CUDA activity only): where the device time goes, and how much
        # of the wall the device is busy at all
        breakdown = asyncio.run(serve(torch, profile=True))
        log("serving profile: " + json.dumps(breakdown))
        log(f"serving profile: decode kernel {breakdown['device_ms']['decode_kernel']:.1f} ms "
            f"of {breakdown['device_busy_ms']:.1f} ms device time, "
            f"{breakdown['launches']['decode']} launches")
        gc.collect()
        torch.cuda.empty_cache()
        # the int8 KV cache with KVBM offload and onboard, unprofiled
        kvbm_run = asyncio.run(serve_kvbm(torch))
        log("serving int8+kvbm: " + json.dumps(kvbm_run))
        log(f"serving int8+kvbm on {smi}: {kvbm_run['requests']} requests, "
            f"{kvbm_run['output_tok_s']:.1f} output tok/s, TTFT median "
            f"{kvbm_run['ttft_s_median'] * 1e3:.0f} ms, ITL median "
            f"{kvbm_run['itl_s_median'] * 1e3:.1f} ms; {kvbm_run['kvbm']['offloaded']} "
            f"blocks offloaded, {kvbm_run['kvbm']['onboarded']} onboarded; repeats "
            f"streaming their first run's greedy tokens: "
            f"{kvbm_run['repeats_streaming_the_same_greedy_tokens']} (a finding, not "
            f"a gate); float run: {serving['output_tok_s']:.1f} tok/s, TTFT median "
            f"{serving['ttft_s_median'] * 1e3:.0f} ms, ITL median "
            f"{serving['itl_s_median'] * 1e3:.1f} ms")
        gc.collect()
        torch.cuda.empty_cache()
        # Gemma: every attention call through the unified kernel, windows
        # and softcap per layer; bf16, then a short int8 run
        gemma_runs = {}
        for int8 in (False, True):
            run = asyncio.run(serve_gemma(torch, int8=int8))
            gemma_runs["int8" if int8 else "bf16"] = run
            tag = "gemma int8" if int8 else "gemma"
            log(f"serving {tag}: " + json.dumps(run))
            log(f"serving {tag} on {smi}: {run['requests']} requests, "
                f"{run['output_tok_s']:.1f} output tok/s, TTFT median "
                f"{run['ttft_s_median'] * 1e3:.0f} ms (max {run['ttft_s_max'] * 1e3:.0f}), "
                f"ITL median {run['itl_s_median'] * 1e3:.1f} ms; unified launches "
                f"{run['launches']['unified_int8' if int8 else 'unified']}, windowed "
                f"{run['launches']['unified_windowed']}; steps {run['steps']}")
            gc.collect()
            torch.cuda.empty_cache()
        # each Gemma traffic again on a fresh engine under torch.profiler
        for int8 in (False, True):
            tag = "gemma int8" if int8 else "gemma"
            prof = asyncio.run(serve_gemma(torch, int8=int8, profile=True))
            log(f"serving {tag} profile: " + json.dumps(prof))
            log(f"serving {tag} profile: {prof['launches_with_split_rows']} of "
                f"{prof['launches']['unified_int8' if int8 else 'unified']} unified launches "
                f"split rows ({prof['split_rows']} rows split, by the kernel's count)")
            gc.collect()
            torch.cuda.empty_cache()
    log(f"serve phase [{time.perf_counter() - t_phase:.1f} s]")
    if "horizon" in phases:
        t0 = time.perf_counter()
        hz = horizon_phase(torch, smi)
        log("horizon: " + json.dumps(hz))
        log(f"horizon phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "gptoss" in phases:
        t0 = time.perf_counter()
        gptoss_results, gpt = gptoss_phase(torch, gen, smi, flex)
        results.update(gptoss_results)
        log("gptoss: " + json.dumps({k: v for k, v in gpt.items() if k != "serving"}))
        log(f"gptoss phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    if "moe_mla" in phases:
        t0 = time.perf_counter()
        latent_results, lat = moe_mla_phase(torch, gen, smi, _build)
        results.update(latent_results)
        log("moe_mla: " + json.dumps({k: v for k, v in lat.items()
                                      if k not in ("serving", "qwen_serving")}))
        log(f"moe_mla phase [{time.perf_counter() - t0:.1f} s]")
        gc.collect()
        torch.cuda.empty_cache()
    log(f"all phases [{time.perf_counter() - t_start:.1f} s]")
    if phases != set(PHASES):
        log("partial run (--phases): no report")
        return 1
    # launches: each kernel's count from the serving run of its path (the
    # float run for the float kernels, the int8 + KVBM run for the rest,
    # the Gemma run for the merge; the gpt-oss runs for the d = 64 forms,
    # which share the unified kernel's and the merge's counters with the
    # other head dims: each run counts only its own; the DeepSeek-V2-Lite
    # serving run for the latent kernel). The page-copy kernel counts its
    # launches by move: while serving, every gather and scatter is the
    # engine's layer-batched one (gather_layers / scatter_layers), so the
    # gather rows (gather_blocks, gather_layers) show the same count, and
    # the scatter rows too; no engine path copies pages, as in the reference
    kernels = []
    for name, key, run in (
            ("paged_decode_attention", "decode", serving),
            ("flash_extend_attention", "flash_extend", serving),
            ("ragged_paged_attention", "unified", serving),
            ("paged_decode_attention_int8", "decode_int8", kvbm_run),
            ("flash_extend_attention_int8", "flash_extend_int8", kvbm_run),
            ("ragged_paged_attention_int8", "unified_int8", kvbm_run),
            ("gather_blocks", "gather", kvbm_run),
            ("scatter_blocks", "scatter", kvbm_run),
            ("copy_blocks", "copy", kvbm_run),
            ("gather_layers", "gather", kvbm_run),
            ("scatter_layers", "scatter", kvbm_run),
            ("ragged_paged_attention_gemma", "unified", gemma_runs["bf16"]),
            ("ragged_paged_attention_gemma_int8", "unified_int8", gemma_runs["int8"]),
            ("merge_attention_partials", "merge", gemma_runs["bf16"]),
            ("ragged_paged_attention_gptoss", "unified", gpt["serving"]["bf16"]),
            ("ragged_paged_attention_gptoss_int8", "unified_int8", gpt["serving"]["int8"]),
            ("merge_attention_partials_gptoss", "merge", gpt["serving"]["bf16"]),
            ("latent_paged_attention", "latent", lat["serving"]["bf16"])):
        r = dict(results[name], launches=run["launches"][key])
        r["max_err"], r["kernel_ms"] = r["max_abs_err"], r["ms"]
        kernels.append(r)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
