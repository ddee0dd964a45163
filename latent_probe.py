"""Times the latent (MLA) attention kernel on the card, by case and by part.

    python3 latent_probe.py [--out FILE]

Each case of chip_smoke.LATENT_CASES: the kernel against its plain version
(the op over the cache as keys and values, cut to 512 lanes; chip_smoke's
limits), then its time (chip_smoke.Timer: median of 15 calls, L2 flushed
before each). Then each form by part, on decode rows that fill the card
once (132 blocks): rows of one key tile each, rows of one 256-key split
each (no merge), and one 8000-key row of 32 splits merged in the launch;
their differences give a tile's time on a full card and the merge's tail.
Prints the card's name and power limit first and one JSON object last.
Run from two checkouts in one call, it compares two versions of the
kernel on one card. Needs one CUDA card and nvcc; exits 2 without a card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the time by part, per form: (query heads, decode rows that fill the card
# once, keys of one tile)
BY_PART = {"narrow": (16, 132, 32), "wide": (128, 66, 64)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("latent_probe: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from dynamo_tpu_torch.ops import _build, cuda_mla
    from dynamo_tpu_torch.ops import attention as att

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.log(f"card: {smi}")
    t0 = time.perf_counter()
    _build.load("mla_attention.cu")
    with open(os.path.join(_build.build_dir(), "libmla_attention.so.log")) as f:
        ptxas = cs.ptxas_summary(f.read())
    cs.log(f"built in {time.perf_counter() - t0:.1f} s: " + " | ".join(ptxas))
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer(torch)

    def inputs(h, rows):
        return cs.latent_inputs(torch, gen, h, rows)[:2]

    def kernel_ms(a, kw):
        return timer(lambda: cuda_mla.latent_paged_attention(*a, **kw))

    cases = {}
    for name, (h, rows) in cs.LATENT_CASES.items():
        a, kw = inputs(h, rows)
        got = cuda_mla.latent_paged_attention(*a, **kw)
        plain = att.ragged_paged_attention(a[0], a[1], a[1], *a[2:])[..., :cs.LV]
        err = cs.compare(torch, got, plain, f"latent {name}")
        del got, plain
        cases[name] = {"form": cuda_mla.tile_shape(h, kw["max_q_len"])[0], "h": h,
                       "ms": kernel_ms(a, kw), "max_abs_err": err}
        cs.log(f"  latent {name} ({cases[name]['form']} form): {cases[name]['ms']:.4f} ms, "
               f"max abs err {err:.3g}")
    by_part = {}
    for form, (h, n, tile) in BY_PART.items():
        one, split, row = (kernel_ms(*inputs(h, [(1, tile)] * n)),
                           kernel_ms(*inputs(h, [(1, cuda_mla.SPLIT_KEYS)] * n)),
                           kernel_ms(*inputs(h, [(1, 8000)])))
        by_part[form] = {"one_tile_ms": one, "one_split_ms": split, "row_8000_ms": row,
                         "tile_ms": (split - one) / (cuda_mla.SPLIT_KEYS // tile - 1),
                         "merge_tail_ms": row - split}
        cs.log(f"  latent {form} form by part (G = {h}, {n} decode rows): one {tile}-key tile "
               f"{one:.4f} ms, one 256-key split {split:.4f} ms "
               f"({by_part[form]['tile_ms']:.4f} ms a tile), one 8000-key row of 32 splits "
               f"{row:.4f} ms (the merge's tail {by_part[form]['merge_tail_ms']:.4f} ms)")
    result = {"card": smi, "checkout": HERE, "ptxas": ptxas, "cases": cases,
              "by_part": by_part}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
