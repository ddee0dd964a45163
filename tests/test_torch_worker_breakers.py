"""The frontend's per-worker circuit breakers (llm/discovery.py) against the
reference's, in round-robin and in KV mode.

Each package's ModelPipeline routes the same scripted sequence of requests
over three workers, through a scripted client (which worker each request
reaches, and whether that worker's send fails) and, in KV mode, a scripted
router (round-robin over the workers it is not told to exclude). Both pipelines must reach the
same workers, report the same ``_tripped`` sets and the same breaker
states at every step: a worker whose sends keep failing trips its circuit
after three failures and routing steers around it; with every circuit
open the empty-pool fallback tries a tripped worker rather than none; a
worker excluded by the migration is never counted twice; after the reset
the next request is the half-open probe, and its clean finish closes the
circuit; a departed worker's breaker is pruned.
"""

import asyncio
import types

import pytest

from dynamo_tpu import llm as jllm
from dynamo_tpu.llm.protocols.common import PreprocessedRequest as JRequest
from dynamo_tpu.llm.protocols.common import StopConditions as JStop
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu.runtime import NoResponders as JNoResponders
from dynamo_tpu.runtime import resilience as jres
from dynamo_tpu_torch.llm.discovery import ModelPipeline
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard
from dynamo_tpu_torch.llm.protocols.common import PreprocessedRequest, StopConditions
from dynamo_tpu_torch.runtime import Context, NoResponders
from dynamo_tpu_torch.runtime import resilience as tres
from torch_port_logging import port_logging_restored  # noqa: F401  # dtpu: ignore[UNUSED-IMPORT] — an autouse fixture, alive by its name in this module

WORKERS = (11, 22, 33)


class Side:
    def __init__(self, port: bool):
        self.port = port
        if port:
            self.pipe, self.card, self.req, self.stop = (
                ModelPipeline, ModelDeploymentCard, PreprocessedRequest, StopConditions)
            self.ctx, self.no_responders, self.res = Context, NoResponders, tres
        else:
            self.pipe, self.card, self.req, self.stop = (
                jllm.ModelPipeline, jllm.ModelDeploymentCard, JRequest, JStop)
            self.ctx, self.no_responders, self.res = JContext, JNoResponders, jres


SIDES = (Side(False), Side(True))


class _Stream:
    def __init__(self, iid):
        self.instance_id = iid
        self._items = [{"token_ids": [7]}, {"finish_reason": "length", "token_ids": []}]

    def __aiter__(self):
        return self

    async def __anext__(self):
        if not self._items:
            raise StopAsyncIteration
        return self._items.pop(0)


class ScriptedClient:
    """The endpoint client: round-robin when the pipeline leaves the choice
    to it; a send to a worker in ``failing`` raises NoResponders."""

    def __init__(self, side):
        self.side = side
        self.instances = {i: types.SimpleNamespace(metadata={}) for i in WORKERS}
        self.failing = set()
        self.sent = []
        self._rr = 0

    def instance_ids(self):
        return sorted(self.instances)

    async def generate(self, obj, context, instance_id=None):
        if instance_id is None:
            ids = self.instance_ids()
            instance_id = ids[self._rr % len(ids)]
            self._rr += 1
        self.sent.append(instance_id)
        if instance_id in self.failing:
            e = self.side.no_responders(f"send {instance_id}: dropped")
            e.instance_id = instance_id
            raise e
        return _Stream(instance_id)


class ScriptedRouter:
    """A KV router that picks round-robin over the workers not excluded,
    and logs the exclusion set of each decision."""

    def __init__(self):
        self.scheduler = types.SimpleNamespace(known_workers=lambda: [])
        self.excluded = []
        self._rr = 0

    def schedule_tokens(self, tokens, excluded=(), **kw):
        out = {w.worker_id for w in excluded}
        self.excluded.append(sorted(out))
        live = [i for i in WORKERS if i not in out]
        pick = live[self._rr % len(live)]
        self._rr += 1
        return types.SimpleNamespace(worker=types.SimpleNamespace(worker_id=pick, dp_rank=0),
                                     overlap_blocks=0, query_blocks=1)

    def register_worker(self, w):
        pass

    def remove_worker_id(self, iid):
        pass


def _states(pipe):
    return {iid: cb.state for iid, cb in sorted(pipe._worker_breakers.items())}


async def _route(side, kv: bool, script) -> list:
    """Run ``script`` (a list of steps) on one package's pipeline."""
    card = side.card(name="m", tokenizer="byte", context_length=256, migration_limit=2)
    pipe = side.pipe(None, card)
    pipe.client = client = ScriptedClient(side)
    if kv:
        pipe.kv_router = ScriptedRouter()
    trace = []
    n = 0
    for step, arg in script:
        if step == "failing":
            client.failing = set(arg)
        elif step == "sleep":
            await asyncio.sleep(arg)
        elif step == "leave":
            client.instances.pop(arg)
        else:   # "send", with the migration's excluded list
            n += 1
            req = side.req(request_id=f"r{n}", model="m", token_ids=[1, 2, 3, 4, 5],
                           stop=side.stop(max_tokens=2))
            tripped = pipe._tripped(list(arg))
            try:
                stream = await pipe._send(req, side.ctx(), list(arg))
                got = [item async for item in stream]
                outcome = ("ok", len(got))
            except side.no_responders as e:
                outcome = ("no_responders", getattr(e, "instance_id", None))
            trace.append((tripped, client.sent[-1] if client.sent else None, outcome,
                          _states(pipe)))
    if kv:
        trace.append(pipe.kv_router.excluded)
    return trace


SCRIPT = (
    [("failing", [22])]
    + [("send", [])] * 6                       # 22 fails three times: open
    + [("send", [])] * 4                       # steered around 22
    + [("send", [11])]                         # a migration retry off 11
    + [("failing", [11, 33])]
    + [("send", [])] * 8                       # every circuit opens
    + [("send", [11])]                         # fallback never re-counts 11
    + [("failing", []), ("sleep", 0.35)]       # the reset elapses
    + [("send", [])] * 4                       # probes close the circuits
    + [("leave", 33), ("send", [])]            # 33 departs: its breaker goes
)


@pytest.mark.parametrize("kv", [False, True], ids=["round_robin", "kv"])
async def test_worker_breakers_steer_as_the_reference(kv, monkeypatch):
    monkeypatch.setenv("DTPU_CB_WORKER", "reset=0.3")
    ref, port = [await _route(side, kv, SCRIPT) for side in SIDES]
    assert port == ref
    steps = port[:-1] if kv else port
    open_22 = next(i for i, s in enumerate(steps) if s[3].get(22) == "open")
    # once 22 is open, nothing reaches it until the empty-pool fallback
    assert all(s[1] != 22 for s in steps[open_22 + 1:open_22 + 5])
    assert [s[0] for s in steps[open_22 + 1:open_22 + 5]] == [[22]] * 4
    all_open = [s for s in steps if set(s[3].values()) == {"open"} and len(s[3]) == 3]
    assert all_open, "the script never opened every circuit"
    after = steps[steps.index(all_open[0]) + 1]
    assert after[0] == []                       # the fallback: steer around none
    # after the reset the probes closed every circuit
    assert set(steps[-2][3].values()) == {"closed"}
    assert 33 not in steps[-1][3]               # pruned with its worker


@pytest.mark.parametrize("side", SIDES, ids=["reference", "port"])
def test_tripped_fallback_over_live_instances(side):
    """``_tripped`` on hand-set breakers: open circuits are avoided unless
    that empties the pool, counted over live instances only."""
    card = side.card(name="m", tokenizer="byte", context_length=256)
    pipe = side.pipe(None, card)
    pipe.client = ScriptedClient(side)
    for iid in (11, 22):
        cb = pipe._worker_cb(iid)
        for _ in range(3):
            cb.record(False)
    assert pipe._tripped([]) == [11, 22]
    assert pipe._tripped([33]) == []            # 33 excluded + 11, 22 open: empty
    assert pipe._tripped([11]) == [22]          # 33 still serves
    pipe.client.instances.pop(33)
    assert pipe._tripped([]) == []              # only tripped workers remain
    pipe._worker_cb(44)                          # a breaker of a departed worker
    pipe._tripped([])
    assert 44 not in pipe._worker_breakers
