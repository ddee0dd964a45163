"""The port's async chunk prep and step telemetry against the reference's.

Mirrors tests/test_step_prep.py's five tests, each run on both packages'
``ChunkPrep`` / ``StepStats`` (the bench summary the reference's last test
reads is replaced by the port's telemetry projection, held to the
reference's ``EngineTelemetry`` on one seeded StepStats stream). Then the
engine: TorchEngine(device="cpu") streams with prep on equal those with
prep off and TpuEngine's on the same tiny weights, on prompts of several
prefill chunks queued together (prefill and mixed chunks take prebuilds),
and the chunk steps' StepStats show the hits.
"""

import re

import numpy as np
import pytest

from dynamo_tpu.engine import prep as jprep
from dynamo_tpu.engine import telemetry as jtele
from dynamo_tpu.runtime import metrics as jmetrics
from dynamo_tpu_torch.engine import prep as tprep
from dynamo_tpu_torch.engine import telemetry as ttele
from dynamo_tpu_torch.runtime import metrics as tmetrics
from torch_feature_engines import Weights, serve, tokens

PACKAGES = pytest.mark.parametrize("prep", [jprep, tprep], ids=["reference", "port"])


def _chunk_arrays(token_ids, start, chunk_len, block_ids):
    """A stand-in with the engine's shape contract (pure function)."""
    bs = 4
    S_pad = ((chunk_len + 15) // 16) * 16
    toks = np.zeros(S_pad, np.int32)
    toks[:chunk_len] = token_ids[start:start + chunk_len]
    positions = np.arange(start, start + S_pad, dtype=np.int32)
    nbi = np.zeros(S_pad // bs, np.int32)
    real = block_ids[start // bs:][:S_pad // bs]
    nbi[:len(real)] = real
    return toks, positions, nbi


@PACKAGES
def test_prep_hit_returns_identical_arrays(prep):
    p = prep.ChunkPrep(_chunk_arrays, upload=None)
    prompt, blocks = list(range(100)), list(range(1, 26))
    p.schedule("r1", prompt, 16, 16, blocks)
    arrays, uploads = p.take("r1", prompt, 16, 16, blocks)
    for a, b in zip(arrays, _chunk_arrays(prompt, 16, 16, blocks)):
        np.testing.assert_array_equal(a, b)
    assert uploads is None
    assert p.last["hit"] is True and p.last["build_s"] >= 0.0
    p.stop()


@PACKAGES
def test_prep_key_mismatch_falls_back(prep):
    p = prep.ChunkPrep(_chunk_arrays, upload=None)
    prompt, blocks = list(range(100)), list(range(1, 26))
    p.schedule("r1", prompt, 16, 16, blocks)
    assert p.take("r1", prompt, 32, 16, blocks) is None   # moved start
    assert p.last == {"hit": False, "build_s": 0.0, "wait_s": 0.0}
    p.schedule("r1", prompt, 16, 16, blocks)
    assert p.take("r1", prompt, 16, 16, blocks[:-1]) is None   # block span
    assert p.take("r2", prompt, 16, 16, blocks) is None   # unknown request
    assert p.last is None
    # a reused request id with another prompt in the chunk's slice misses
    p.schedule("r1", prompt, 16, 16, blocks)
    edited = list(prompt)
    edited[20] = 999
    assert p.take("r1", edited, 16, 16, blocks) is None
    # content outside the chunk's slice is irrelevant
    p.schedule("r1", prompt, 16, 16, blocks)
    tail = list(prompt)
    tail[90] = 999
    assert p.take("r1", tail, 16, 16, blocks) is not None
    p.stop()


@PACKAGES
def test_prep_upload_callable_and_failure_isolation(prep):
    calls = []

    def upload(a):
        calls.append(a.shape)
        return ("dev", a)

    p = prep.ChunkPrep(_chunk_arrays, upload=upload)
    prompt, blocks = list(range(64)), list(range(1, 17))
    p.schedule("r", prompt, 0, 16, blocks)
    arrays, uploads = p.take("r", prompt, 0, 16, blocks)
    assert len(uploads) == 3 and all(u[0] == "dev" for u in uploads)
    assert len(calls) == 3

    def boom(*a):
        raise RuntimeError("prep exploded")

    bad = prep.ChunkPrep(boom, upload=None)
    bad.schedule("r", prompt, 0, 16, blocks)
    assert bad.take("r", prompt, 0, 16, blocks) is None
    assert bad.last["hit"] is False
    bad.stop()
    p.stop()


@PACKAGES
def test_prep_env_gate(prep, monkeypatch):
    monkeypatch.delenv("DTPU_ASYNC_PREP", raising=False)
    assert prep.async_prep_enabled()
    for off in ("0", "false", "off", ""):
        monkeypatch.setenv("DTPU_ASYNC_PREP", off)
        assert not prep.async_prep_enabled()
    monkeypatch.setenv("DTPU_ASYNC_PREP", "1")
    assert prep.async_prep_enabled()


def stats_stream(tele, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(300):
        phase = str(rng.choice(["prefill", "decode", "mixed"]))
        chunk = phase != "decode"
        out.append(tele.StepStats(
            phase=phase, duration_s=float(rng.choice([0.002, 0.02, 1.5])),
            batch_occupancy=int(rng.integers(0, 9)), batch_size=8,
            tokens=int(rng.integers(0, 2100)), queue_depth=int(rng.integers(0, 5)),
            kv_active_blocks=int(rng.integers(0, 2048)), kv_free_blocks=int(rng.integers(0, 2048)),
            kv_total_blocks=2048,
            spec_acceptance=float(rng.random()) if i % 7 == 0 else None,
            prep_hit=bool(rng.random() < 0.8) if chunk else None,
            prep_build_s=0.001 if chunk else 0.0, prep_wait_s=0.0001 if chunk else 0.0))
    return out


def project(tele, metrics) -> tuple:
    scope = metrics.MetricsScope().child(dtpu_namespace="ns", dtpu_component="backend")
    t = tele.EngineTelemetry(scope.child(dp_rank="0"), slow_step_s=1.0)
    for s in stats_stream(tele):
        t.on_step(s)
    # the exposition text line for line: a family's children in creation
    # order, as prometheus_client renders them
    text = re.sub(r"_created(\{[^}]*\})? \S+", r"_created\1 <t>", scope.expose().decode())
    return t.snapshot(), text.splitlines()


def test_step_stats_carry_prep_fields_and_project_as_the_reference():
    for tele in (jtele, ttele):
        d = tele.StepStats(phase="decode", duration_s=0.01, batch_occupancy=2, batch_size=4,
                           tokens=4, queue_depth=0, kv_active_blocks=1, kv_free_blocks=1,
                           kv_total_blocks=2)
        assert d.prep_hit is None and d.prep_build_s == 0.0 and d.prep_wait_s == 0.0
    assert ttele.StepStats(phase="decode", duration_s=0.0, batch_occupancy=0, batch_size=1,
                           tokens=0, queue_depth=0, kv_active_blocks=0, kv_free_blocks=0,
                           kv_total_blocks=0).passes == 1
    ref, port = project(jtele, jmetrics), project(ttele, tmetrics)
    assert port == ref
    assert port[0]["slow_steps_total"] > 0
    assert any(ln.startswith('dtpu_engine_step_duration_seconds_count{dp_rank="0"')
               for ln in port[1])


MODEL = dict(vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
             head_dim=16, intermediate_size=128)
ENGINE = dict(num_blocks=256, block_size=4, max_batch_size=4, max_context=512,
              prefill_buckets=(16, 32))


def batches() -> list:
    """Prompts of 3-5 chunks of 32 queued together (a prompt's later chunks
    ride mixed steps once another decodes), then one more alone."""
    first = [(f"r{i}", tokens(30 + i, n, 512), 12, {})
             for i, n in enumerate((70, 150, 95))]
    return [first, [("late", tokens(40, 120, 512), 8, {})]]


def test_engine_streams_with_prep_on_equal_prep_off_and_the_reference(monkeypatch):
    w = Weights(MODEL)
    runs = {}
    for on in (True, False):
        monkeypatch.setenv("DTPU_ASYNC_PREP", "1" if on else "0")
        engine = w.torch_engine(ENGINE, decode_steps=1)
        assert (engine._prep is not None) == on
        steps = []
        engine.stats_hook = steps.append
        runs[on] = (serve(engine, batches()), steps)
    monkeypatch.delenv("DTPU_ASYNC_PREP")
    ref = serve(w.jax_engine(ENGINE), batches())
    assert [r["tokens"] for r in runs[True][0]] == [r["tokens"] for r in runs[False][0]]
    assert [r["tokens"] for r in runs[True][0]] == [r["tokens"] for r in ref]
    assert [r["finish"] for r in runs[True][0]] == [r["finish"] for r in ref]
    chunks = [s for s in runs[True][1] if s.phase in ("prefill", "mixed")]
    hits = [s for s in chunks if s.prep_hit]
    assert hits and {s.phase for s in hits} == {"prefill", "mixed"}
    assert all(s.prep_build_s > 0 for s in hits)
    assert all(s.prep_hit is None for s in runs[False][1])
    assert all(s.prep_hit is None for s in runs[True][1] if s.phase == "decode")
