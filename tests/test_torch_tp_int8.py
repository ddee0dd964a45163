"""tests/test_torch_tp_engine.py on the int8 KV cache: a two-process
``TorchEngine(tp=2, device="cpu", kv_dtype="int8")`` (each rank's int8
pages and f32 scale rows on its own kv heads) streams the reference
``TpuEngine``'s greedy tokens at tp=2 and at tp=1 on the int8 cache, and
its follower sampled exactly what its leader did."""

import pytest

from test_torch_tp_engine import check_tp_streams, tp_streams


@pytest.fixture(scope="module")
def int8_streams(tmp_path_factory):
    return tp_streams(tmp_path_factory.mktemp("tp_int8"), "int8")


def test_tp2_int8_engine_streams_the_references_greedy_tokens_at_tp2_and_tp1(int8_streams):
    check_tp_streams(*int8_streams)


def test_tp2_int8_follower_sampled_what_its_leader_sampled(int8_streams):
    _, _, (leader, follower) = int8_streams
    assert follower["sampled"] == leader["sampled"]
    assert leader["streams"]["chunked"]["tokens"]
