"""Collectives of a tensor-parallel group over ``torch.distributed``: the
sum all-reduce after each row-parallel product (the reference's GSPMD
``psum``) and the all-gathers of the embedding's hidden shards and of the
logits' vocabulary shards.

The backend follows the topology and is printed when the group starts
(``init_group``); it is never chosen by catching an error:

- gloo on the CPU;
- NCCL when every rank has a card of its own;
- gloo on CUDA tensors when ranks share a card. NCCL refuses two ranks on
  one device ("Duplicate GPU detected"); gloo copies each collective's
  tensors through the host. Such a collective cannot be captured in a
  CUDA graph, so the engine refuses ``cuda_graphs`` over it
  (``host_staged``).

Every rank gets the same bits back from each call: a ring all-reduce sums
each element on one rank and shares that sum, and a gather only moves
bits. The engine's replicated sampling relies on it: every rank samples
the same token from the same logits, so no token is broadcast. The
all-reduce sums in float32 and returns the input's dtype.

``counts`` tallies the calls by kind, and the forward passes that made
them (models/llama.forward); inside a CUDA-graph capture a call counts
once, at the capture.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Dict

import torch
import torch.distributed as dist

log = logging.getLogger("dynamo_tpu_torch.parallel.comm")


def choose_backend(device: torch.device, world: int) -> str:
    """gloo on the CPU, NCCL when the ``world`` ranks each have a card of
    their own, gloo on CUDA tensors when they share cards."""
    if device.type != "cuda":
        return "gloo"
    return "nccl" if world <= torch.cuda.device_count() else "gloo"


class TpComm:
    """The collectives of one rank of a TP group (``group`` None: the
    default process group)."""

    def __init__(self, rank: int, size: int, device: torch.device, backend: str,
                 group=None):
        self.rank, self.size, self.device = rank, size, torch.device(device)
        self.backend = backend
        self.group = group
        self.counts: Dict[str, int] = {"all_reduce": 0, "all_gather": 0, "forwards": 0}

    @property
    def host_staged(self) -> bool:
        """Whether collectives go through the host (gloo on CUDA tensors):
        none of them can be captured in a CUDA graph."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``, in ``x``'s dtype (summed in
        float32; a float32 ``x`` is reduced in place)."""
        self.counts["all_reduce"] += 1
        y = x.float().contiguous()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=self.group)
        return y.to(x.dtype)

    def all_gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim``, in rank order."""
        self.counts["all_gather"] += 1
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        return torch.cat(parts, dim=dim)

    def note_forward(self) -> None:
        self.counts["forwards"] += 1

    def reset_counts(self) -> None:
        for k in self.counts:
            self.counts[k] = 0


def init_group(rank: int, size: int, init_method: str, device: torch.device,
               timeout_s: float = 1800.0) -> TpComm:
    """Join the TP group as rank ``rank`` of ``size`` (``init_method``:
    ``tcp://host:port`` of rank 0), on the backend ``choose_backend``
    picks, which is printed."""
    device = torch.device(device)
    backend = choose_backend(device, size)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, world_size=size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    comm = TpComm(rank, size, device, backend)
    note = (" (ranks share the card: gloo copies each collective through the host; "
            "horizons run eagerly)" if comm.host_staged else "")
    # one write a line: the ranks of a local group share an output pipe
    print(f"TP_GROUP rank={rank}/{size} backend={backend} device={device} pid={os.getpid()}"
          f"{note}\n", end="", flush=True)
    log.info("tp group: rank %d of %d on %s, backend %s", rank, size, device, backend)
    return comm


def destroy_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()
