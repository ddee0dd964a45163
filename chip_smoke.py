#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (dynamo_tpu_torch) on one GPU.

    python3 chip_smoke.py                    # every phase (what CI runs)
    python3 chip_smoke.py --phases kernels   # build + kernel checks only

Phases, in order; any failure raises and the exit code is not 0:

1. environment: the card's name and power limit (nvidia-smi), torch and
   CUDA versions; builds every kernel of dynamo_tpu_torch/csrc from source.
2. kernels: each CUDA kernel against its plain PyTorch version at
   Llama-3-8B attention shapes in bf16 (32 q heads, 8 kv heads, head_dim
   128, block 16) on ragged rows; times kernel, plain version, a PyTorch
   library call doing the same work (scaled_dot_product_attention over the
   gathered KV; the port never calls it) and the card's bound.
3. model: a 2-layer model at full Llama-3-8B width runs a prefill, decode
   steps and a ragged 2-token step through the model's attend hook, once
   with the kernels and once with the plain ops; the logits must agree,
   and three deliberately wrong attentions must not, on each of 3 seeds.
4. serving: TorchEngine on the llama3-8b preset at full depth (32 layers,
   random bf16 weights from a seed) serves staggered concurrent requests;
   every request must finish with its token count, and the decode,
   flash-extend and unified kernels and the fused mixed step must all have
   run during it.
5. report: one JSON line with every kernel's numbers, the nvidia-smi line,
   and last the device line ``{"ok": true, "device": {...}}``.

Exits non-zero without printing a result when no CUDA device is present or
when the dynamo_tpu_torch package is not beside this script.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
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

    def __call__(self, fn, reps: int = 15, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(200_000)
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


# ------------------------------------------------------------- phase 2
def paged_case(torch, gen, lens, num_blocks, kvh=KVH):
    """Random bf16 paged cache with each row on scrambled distinct pages
    (table padding -> scratch block 0)."""
    dev = "cuda"
    kc = torch.randn(num_blocks, BS, kvh, D, generator=gen, device=dev).to(torch.bfloat16)
    vc = torch.randn(num_blocks, BS, kvh, D, generator=gen, device=dev).to(torch.bfloat16)
    mb = max(-(-n // BS) for n in lens) + 4
    tables = np.zeros((len(lens), mb), np.int32)
    free = list(np.random.default_rng(0).permutation(np.arange(1, num_blocks)))
    for r, n in enumerate(lens):
        for j in range(-(-n // BS)):
            tables[r, j] = free.pop()
    return kc, vc, torch.as_tensor(tables, device=dev)


def expand_kv(torch, kc, vc, table, T):
    """Gathered [T, H, D] K/V of one row with kv heads repeated to q heads
    (the library yardstick's input)."""
    from dynamo_tpu_torch.ops import attention as att

    k, v = att.gather_kv(kc, vc, table)
    g = H // KVH
    return (k[:T].repeat_interleave(g, dim=1).transpose(0, 1),
            v[:T].repeat_interleave(g, dim=1).transpose(0, 1))


def check_decode(torch, gen, timer):
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention

    lens = [1, 17, 250, 999, 2100, 513, 77, 1500]
    kc, vc, tables = paged_case(torch, gen, lens, num_blocks=512)
    B = len(lens)
    q = torch.randn(B, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    seq_lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
    args = (q, kc, vc, tables, seq_lens)
    err = compare(torch, cuda_attention.paged_decode_attention(*args),
                  att.paged_decode_attention(*args), "decode")
    T = max(lens)
    ks, vs = zip(*(expand_kv(torch, kc, vc, tables[r], T) for r in range(B)))
    kl, vl = torch.stack(ks), torch.stack(vs)                  # [B, H, T, D]
    mask = (torch.arange(T, device="cuda")[None, :] < seq_lens[:, None])[:, None, None, :]
    ql = q[:, :, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    n_keys = sum(lens)
    b, by = bound(
        2 * (2 * B * H * D                      # q in, out
             + 2 * n_keys * KVH * D)            # K and V rows needed
        + 4 * (B + sum(-(-n // BS) for n in lens)),
        4 * n_keys * H * D,
    )
    return {
        "name": "paged_decode_attention", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/decode_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_attention.py:36",
        "shape": f"B={B} lens={lens} h={H} kvh={KVH} d={D} bs={BS} bf16",
        "max_abs_err": err,
        "ms": timer(lambda: cuda_attention.paged_decode_attention(*args)),
        "plain_ms": timer(lambda: att.paged_decode_attention(*args)),
        "library_ms": timer(lambda: sdpa(ql, kl, vl, attn_mask=mask)),
        "bound_ms": b, "bound_by": by,
    }


def check_flash(torch, gen, timer):
    from dynamo_tpu_torch.ops import cuda_prefill

    def case(S, start, total):
        T = -(-total // BS) * BS
        q = torch.randn(S, H, D, generator=gen, device="cuda").to(torch.bfloat16)
        k = torch.randn(T, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
        v = torch.randn(T, KVH, D, generator=gen, device="cuda").to(torch.bfloat16)
        return q, k, v, start, total

    # a ragged continuation chunk (952 real rows in a 1024 bucket over a
    # 2048-token prefix), checked only, then the full first chunk, timed
    cont = case(1024, 2048, 3000)
    err = compare(torch, cuda_prefill.flash_extend_attention(*cont),
                  cuda_prefill.flash_extend_reference(*cont), "flash_extend continuation")
    S = 2048
    first = case(S, 0, S)
    err = max(err, compare(torch, cuda_prefill.flash_extend_attention(*first),
                           cuda_prefill.flash_extend_reference(*first), "flash_extend"))
    q, k, v, _, _ = first
    g = H // KVH
    ql = q.transpose(0, 1)[None].contiguous()
    kl = k.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    vl = v.repeat_interleave(g, dim=1).transpose(0, 1)[None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    pairs = S * (S + 1) // 2
    b, by = bound(2 * (2 * S * H * D + 2 * S * KVH * D), 4 * pairs * H * D)
    return {
        "name": "flash_extend_attention", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/flash_extend.cu",
        "replaces": "dynamo_tpu/ops/pallas_prefill.py:44",
        "shape": f"S={S} start=0 total={S} h={H} kvh={KVH} d={D} bf16 "
                 "(also checked: S=1024 start=2048 total=3000)",
        "max_abs_err": err,
        "ms": timer(lambda: cuda_prefill.flash_extend_attention(*first)),
        "plain_ms": timer(lambda: cuda_prefill.flash_extend_reference(*first), reps=5),
        "library_ms": timer(lambda: sdpa(ql, kl, vl, is_causal=True)),
        "bound_ms": b, "bound_by": by,
    }


def check_unified(torch, gen, timer):
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_unified

    # (q_len, seq_len): a 437-token prefill segment over a 1200-token
    # prefix, decode rows (one past 2,000 tokens), an empty row; 5-token
    # gaps between segments
    rows = [(437, 1637), (1, 2100), (1, 17), (0, 300), (1, 999), (1, 250), (1, 1)]
    kc, vc, tables = paged_case(torch, gen, [sl for _, sl in rows], num_blocks=512)
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
    err = compare(torch, cuda_unified.ragged_paged_attention(*args, max_q_len=max_q),
                  att.ragged_paged_attention(*args), "unified")
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
             + Tq * H * D                               # packed output
             + 2 * sum(sl for _, sl in live) * KVH * D)  # K and V rows needed
        + 4 * (3 * R + sum(-(-sl // BS) for _, sl in live)),
        4 * pairs * H * D,
    )
    return {
        "name": "ragged_paged_attention", "route": "cuda",
        "source": "dynamo_tpu_torch/csrc/unified_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_unified.py:93",
        "shape": f"rows(q_len,seq_len)={rows} Tq={Tq} h={H} kvh={KVH} d={D} bs={BS} bf16",
        "max_abs_err": err,
        "ms": timer(lambda: cuda_unified.ragged_paged_attention(*args, max_q_len=max_q)),
        "plain_ms": timer(lambda: att.ragged_paged_attention(*args), reps=5),
        "library_ms": timer(lambda: sdpa(qp, kp, vp, attn_mask=mask)),
        "bound_ms": b, "bound_by": by,
    }


def check_group_sizes(torch, gen) -> float:
    """The other query-heads-per-kv-head counts the kernels take (1, 2 and
    8: e.g. qwen3-0.6b has 2, llama3-70b 8), each kernel against its plain
    version on small ragged cases; untimed."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified

    kvh, worst = 2, 0.0
    i32 = dict(dtype=torch.int32, device="cuda")
    for g in (1, 2, 8):
        h = kvh * g
        lens = [1, 40, 333]
        kc, vc, tables = paged_case(torch, gen, lens, num_blocks=64, kvh=kvh)
        q = torch.randn(len(lens), h, D, generator=gen, device="cuda").to(torch.bfloat16)
        args = (q, kc, vc, tables, torch.tensor(lens, **i32))
        worst = max(worst, compare(torch, cuda_attention.paged_decode_attention(*args),
                                   att.paged_decode_attention(*args), f"decode G={g}"))
        qf = torch.randn(77, h, D, generator=gen, device="cuda").to(torch.bfloat16)
        kf = torch.randn(160, kvh, D, generator=gen, device="cuda").to(torch.bfloat16)
        vf = torch.randn(160, kvh, D, generator=gen, device="cuda").to(torch.bfloat16)
        fargs = (qf, kf, vf, 70, 147)
        worst = max(worst, compare(torch, cuda_prefill.flash_extend_attention(*fargs),
                                   cuda_prefill.flash_extend_reference(*fargs),
                                   f"flash_extend G={g}"))
        qu = torch.randn(50, h, D, generator=gen, device="cuda").to(torch.bfloat16)
        uargs = (qu, kc, vc, tables, torch.tensor([0, 40, 45], **i32),
                 torch.tensor([1, 3, 5], **i32), torch.tensor(lens, **i32))
        worst = max(worst, compare(torch, cuda_unified.ragged_paged_attention(*uargs),
                                   att.ragged_paged_attention(*uargs), f"unified G={g}"))
    return worst


# ------------------------------------------------------------- phase 3
def attention_paths(torch, table):
    """The model check's attention paths by name, each a (prefill, decode,
    ragged) triple of ``(q, k_cache, v_cache, total_len) -> out`` on one
    sequence whose pages are ``table``: the kernels, the plain versions,
    and the deliberately wrong attentions the check must tell apart."""
    from dynamo_tpu_torch.ops import attention as att
    from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified

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

    def rotated(fn):
        # query-head group i reads kv head i+1: a wrong GQA map
        return lambda q, kc, vc, total: fn(q, kc.roll(1, dims=2), vc.roll(1, dims=2), total)

    def no_mask(q, kc, vc, total):
        # every query sees all `total` keys
        return plain_prefill(q, kc, vc, total, start=total - 1)

    return {
        "kernels": (
            lambda q, kc, vc, total: cuda_prefill.flash_extend_attention(
                q, *ctx(kc, vc, total), 0, total),
            lambda q, kc, vc, total: cuda_attention.paged_decode_attention(
                q.reshape(1, H, D), kc, vc, table[None], one(total)).reshape(q.shape),
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


def model_logits(torch, cfg, params, paths, prompt, extra):
    """Last-position logits [1, V] (f32) of a prefill, 3 decode steps and a
    2-token ragged step, through each path's attention, per path."""
    from dynamo_tpu_torch.models import llama
    from dynamo_tpu_torch.ops import attention as att

    dev = params["embed"].device
    nb = 48
    table = torch.arange(3, 3 + 32, dtype=torch.int32, device=dev)
    n = len(prompt)
    logits = {}
    for name, (prefill, decode, ragged) in paths(table).items():
        shape = (nb, BS, cfg.num_kv_heads, cfg.head_dim)
        kcs = [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(cfg.num_layers)]
        vcs = [torch.zeros(shape, dtype=cfg.dtype, device=dev) for _ in range(cfg.num_layers)]

        def run(tokens, start, attn):
            pos = torch.arange(start, start + len(tokens), device=dev)
            blocks, offs = table[pos // BS], pos % BS

            def attend(q, k, v, i):
                att.write_decode_kv(kcs[i], vcs[i], k.reshape(-1, *k.shape[-2:]),
                                    v.reshape(-1, *v.shape[-2:]), blocks, offs)
                return attn(q, kcs[i], vcs[i], start + len(tokens))

            hidden = llama.forward(params, cfg, torch.as_tensor(tokens, device=dev), pos, attend)
            return llama.lm_logits(params, cfg, hidden.reshape(-1, cfg.hidden_size)[-1:]).float()

        with torch.inference_mode():
            out = [run(prompt, 0, prefill)]
            out += [run(extra[j:j + 1], n + j, decode) for j in range(3)]
            out.append(run(extra[3:5], n + 3, ragged))
        logits[name] = out
    return logits


def model_check(torch):
    """A 2-layer model at full Llama-3-8B width, per seed in MODEL_SEEDS:
    the kernel path's logits against the plain path's at every step, and
    the same reading for each mutant. Returns (worst kernel reading, least
    reading of each mutant over the seeds, max |logit|)."""
    from dynamo_tpu_torch.models import llama

    dev = torch.device("cuda")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_8b(), num_layers=2)
    readings: dict = {}
    spread = 0.0
    for seed in MODEL_SEEDS:
        params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(seed), dev)
        rng = np.random.default_rng(100 + seed)
        prompt = rng.integers(0, cfg.vocab_size, size=300)
        extra = rng.integers(0, cfg.vocab_size, size=5)   # 3 decode tokens + a 2-token step
        logits = model_logits(torch, cfg, params, lambda t: attention_paths(torch, t),
                              prompt, extra)
        plain = logits.pop("plain")
        spread = max(spread, max(b.abs().max().item() for b in plain))
        for name, got in logits.items():
            if name == "kernels" and not all(torch.isfinite(a).all() for a in got):
                raise AssertionError(f"model seed {seed}: kernel logits not finite")
            rel = max(((a - b).norm() / b.norm()).item() for a, b in zip(got, plain))
            readings.setdefault(name, []).append(rel)
        del params, logits, plain
        torch.cuda.empty_cache()
    for name, rels in readings.items():
        log(f"model: {name}: relative L2 of last-position logits vs plain, worst "
            f"step per seed {MODEL_SEEDS}: " + ", ".join(f"{r:.4g}" for r in rels))
    worst = max(readings["kernels"])
    if worst > MODEL_REL_TOL:
        raise AssertionError(f"model: kernel logits differ from plain by {worst:.4g} "
                             f"relative L2 (limit {MODEL_REL_TOL})")
    for name in MODEL_MUTANTS:
        if min(readings[name]) <= MODEL_REL_TOL:
            raise AssertionError(f"model: the check cannot tell {name} from the plain "
                                 f"path ({min(readings[name]):.4g} <= {MODEL_REL_TOL})")
    return worst, {n: min(r) for n, r in readings.items() if n != "kernels"}, spread


# ------------------------------------------------------------- phase 4
def device_time_by_kind(prof) -> dict:
    """Summed kernel time (ms) from a CUDA-activity profile, by kind."""
    kinds = {"decode_kernel": "paged_decode_kernel", "flash_kernel": "flash_extend_kernel",
             "unified_kernel": "unified_kernel"}
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
    out["top"] = [[name, round(t, 3), c] for t, c, name in sorted(top, reverse=True)[:10]]
    return out


async def serve(torch, profile: bool = False):
    from dynamo_tpu_torch.engine.engine import TorchEngine, TorchEngineConfig
    from dynamo_tpu_torch.llm.protocols.common import (
        PreprocessedRequest, SamplingOptions, StopConditions,
    )
    from dynamo_tpu_torch.llm.tokenizer import ByteTokenizer
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.ops import cuda_attention, cuda_prefill, cuda_unified
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
    kernels = (cuda_attention.KERNEL, cuda_prefill.KERNEL, cuda_unified.KERNEL)
    for k in kernels:
        k.launches = 0
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
                      "itl_s": ((stamps[-1] - stamps[0]) / (len(stamps) - 1)
                                if len(stamps) > 1 else None)})

    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    try:
        await asyncio.gather(*(one(i, p) for i, p in enumerate(prompts)))
    finally:
        engine.stop()
        torch.cuda.synchronize()
        if prof is not None:
            prof.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    launches = [k.launches for k in kernels]
    for s in sorted(stats, key=lambda s: s["i"]):
        if len(s["tokens"]) != max_tokens or s["finish"] != "length":
            raise AssertionError(f"request {s['i']}: {len(s['tokens'])} tokens, "
                                 f"finish {s['finish']!r}; expected {max_tokens}, 'length'")
        if not all(0 <= t < mcfg.vocab_size for t in s["tokens"]):
            raise AssertionError(f"request {s['i']}: token id outside the vocab")
    names = ("decode", "flash_extend", "unified")
    for name, n in zip(names, launches):
        if n <= 0:
            raise AssertionError(f"the {name} kernel never launched while serving")
    if engine.step_counts["mixed"] <= 0:
        raise AssertionError(f"no fused mixed step ran: {engine.step_counts}")
    if prof is not None:
        by_kind = device_time_by_kind(prof)
        busy_ms = sum(v for k, v in by_kind.items() if k not in ("kernels", "top"))
        return {"wall_s": wall, "device_busy_ms": busy_ms,
                "busy_share": busy_ms / (wall * 1e3), "device_ms": by_kind,
                "steps": dict(engine.step_counts)}
    ttft = sorted(s["ttft_s"] for s in stats)
    itl = sorted(s["itl_s"] for s in stats)
    n_out = sum(len(s["tokens"]) for s in stats)
    return {
        "requests": len(stats), "prompt_tokens": lens, "max_tokens": max_tokens,
        "wall_s": wall, "output_tok_s": n_out / wall,
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": ttft[-1],
        "itl_s_median": statistics.median(itl), "itl_s_max": itl[-1],
        "steps": dict(engine.step_counts),
        "launches": dict(zip(names, launches)),
    }


# ------------------------------------------------------------------ main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default="kernels,model,serve",
                    help="comma list of kernels,model,serve (environment and "
                         "build always run; the report needs all three)")
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
                regs = [l.strip() for l in f if "registers" in l or "spill" in l]
            log(f"  {name[:-4]}: " + " | ".join(regs))

    results = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = Timer(torch)
    if "kernels" in phases:
        for check in (check_decode, check_flash, check_unified):
            t0 = time.perf_counter()
            r = check(torch, gen, timer)
            results[r["name"]] = r
            log(f"kernel {r['name']}: max abs err {r['max_abs_err']:.3g} "
                f"(atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL}); "
                f"{r['ms']:.4f} ms kernel, "
                f"{r['plain_ms']:.4f} ms plain, {r['library_ms']:.4f} ms library, "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}) "
                f"[{time.perf_counter() - t0:.1f} s]")
        worst = check_group_sizes(torch, gen)
        log(f"kernels at 1, 2 and 8 query heads per kv head: max abs err "
            f"{worst:.3g} (atol {KERNEL_ATOL}, rtol {KERNEL_RTOL}, row {KERNEL_ROW_REL})")
    del timer
    torch.cuda.empty_cache()
    if "model" in phases:
        t0 = time.perf_counter()
        worst, mutants, spread = model_check(torch)
        log(f"model: 2-layer llama3-8b width, prefill 300 + 3 decode + a 2-token "
            f"ragged step, {len(MODEL_SEEDS)} seeds: kernels vs plain logits relative "
            f"L2 {worst:.4g} at worst (limit {MODEL_REL_TOL}); mutants at least "
            + ", ".join(f"{n[8:]} {r:.4g}" for n, r in mutants.items())
            + f"; max |logit| {spread:.3g} [{time.perf_counter() - t0:.1f} s]")
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
    if phases != {"kernels", "model", "serve"}:
        log("partial run (--phases): no report")
        return 1
    kernels = []
    for name, key in (("paged_decode_attention", "decode"),
                      ("flash_extend_attention", "flash_extend"),
                      ("ragged_paged_attention", "unified")):
        r = dict(results[name], launches=serving["launches"][key])
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
