#!/usr/bin/env python3
"""What two tensor-parallel ranks on ONE card can use for their
collectives (run on the GPU; imports torch only).

    python3 tp_probe.py

Starts two processes of this script on cuda:0 twice: first with NCCL
(which refuses two ranks on one device: the error is printed), then with
gloo on CUDA tensors, where each rank sums a bf16 [8, 4096] tensor in
float32 (parallel/comm.TpComm.all_reduce's form) and gathers a float32
[8, 64128] tensor (a llama3-8b logits shard at tp = 2), checks every rank
got the same bits and the right values, and times each (median of 50,
after a device synchronize). Prints the card's name and power limit, and
one JSON line per backend.
"""

import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(backend: str, rank: int, port: int) -> dict:
    import datetime

    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda:0")
    out = {"backend": backend, "rank": rank}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                                rank=rank, timeout=datetime.timedelta(seconds=60))
        x = torch.full((8, 4096), float(rank + 1), dtype=torch.bfloat16, device=dev)
        y = x.float()
        dist.all_reduce(y)
        torch.cuda.synchronize()
        part = torch.full((8, 64128), float(rank), dtype=torch.float32, device=dev)
        parts = [torch.empty_like(part) for _ in range(2)]
        dist.all_gather(parts, part)
        torch.cuda.synchronize()
        out["all_reduce_ok"] = bool((y == 3.0).all())
        out["all_gather_ok"] = bool(all((p == float(r)).all() for r, p in enumerate(parts)))
        for name, fn in (("all_reduce_s", lambda: dist.all_reduce(x.float())),
                         ("logits_gather_s", lambda: dist.all_gather(parts, part))):
            times = []
            for _ in range(50):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            out[name] = sorted(times)[len(times) // 2]
        dist.destroy_process_group()
    except Exception as e:  # the probe reports what the backend said
        out["error"] = f"{type(e).__name__}: {str(e)[:400]}"
    return out


def run_pair(backend: str) -> list:
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", backend,
                               str(r), str(port)], stdout=subprocess.PIPE, text=True)
             for r in range(2)]
    outs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=180)
            outs.append(json.loads(stdout.strip().splitlines()[-1]))
        except (subprocess.TimeoutExpired, IndexError, json.JSONDecodeError) as e:
            p.kill()
            outs.append({"backend": backend, "error": f"no report: {type(e).__name__}"})
    return outs


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        print(json.dumps(rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))),
              flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("tp_probe: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    for backend in ("nccl", "gloo"):
        print(json.dumps({"backend": backend, "ranks": run_pair(backend)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
