"""Where a spec stream leaves the plain greedy stream, how far apart the two
tokens are in the plain model.

    python3 spec_tie_probe.py [--layers N] [--out FILE]

Serves chip_smoke's decode-heavy prompts (8 prompts of 128 tokens, 128
greedy tokens each) on llama3-8b cut to N layers (default 16; random bf16
weights from seed 0), once plain with the top 8 logprobs a token, once
with the main's own weights as the spec draft (k = chip_smoke.SPEC_K).
At each request's first difference it prints the spec token's rank among
the plain run's top 8 (None: below them), both tokens' float32 logits
from chip_smoke.plain_logits at that prefix, their gap, and chip_smoke's
tie limit (TIE_SPACINGS bf16 spacings at the larger logit). Prints the
card's name and power limit first and one JSON object last. Needs one
CUDA card and nvcc; exits 2 without a card.
"""

import argparse
import asyncio
import dataclasses
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
TOP = 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("spec_tie_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from dynamo_tpu_torch.models import registry
    from dynamo_tpu_torch.models.llama import LlamaConfig
    from dynamo_tpu_torch.ops import _build

    smi = cs.nvidia_smi_line()
    cs.log(f"card: {smi}")
    _build.build_all()
    mcfg = dataclasses.replace(LlamaConfig.llama3_8b(), num_layers=args.layers)
    params = registry.init_params(mcfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    prompts = cs.horizon_prompts()
    common = dict(mcfg=mcfg, tokens=cs.SPEC_TOKENS, sampled=None)
    plain, eng = asyncio.run(cs.serve_decode_heavy(torch, params, prompts, logprobs=TOP,
                                                   **common))
    del eng
    spec, eng = asyncio.run(cs.serve_decode_heavy(
        torch, params, prompts, spec_k=cs.SPEC_K, spec_draft=mcfg, draft_params=params,
        **common))
    del eng
    parts = []
    for r, p, prompt in zip(spec["requests"], plain["requests"], prompts):
        a, b = r["tokens"], p["tokens"]
        j = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if j is None:
            continue
        top = p["top"][j]
        ranked = sorted(top, key=top.get, reverse=True)
        logits = cs.plain_logits(torch, params, mcfg, list(prompt) + b[:j])
        la, lb = float(logits[a[j]]), float(logits[b[j]])
        limit = cs.TIE_SPACINGS * cs.bf16_spacing(max(la, lb))
        parts.append({"request": r["i"], "index": j, "plain_token": b[j], "spec_token": a[j],
                      "spec_rank": ranked.index(a[j]) + 1 if a[j] in top else None,
                      "top": {str(t): top[t] for t in ranked},
                      "plain_logit": lb, "spec_logit": la, "gap": lb - la, "limit": limit,
                      "within": lb - la <= limit})
        cs.log(f"  request {r['i']} token {j}: plain {b[j]} (logit {lb:.6g}), spec {a[j]} "
               f"(logit {la:.6g}, rank {parts[-1]['spec_rank']} of the top {TOP}): gap "
               f"{lb - la:.4g}, limit {limit:.4g}")
    result = {"card": smi, "layers": args.layers, "acceptance": spec["spec"]["acceptance"],
              "requests": len(prompts), "parted": parts}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
