"""Serving HF checkpoints of the other families: TorchEngine (on the
CPU) on the port-loaded parameters of a Gemma 3, a gpt-oss (MXFP4
experts) and a DeepSeek V3 (MLA) checkpoint streams TpuEngine's greedy
tokens on the reference-loaded ones, for a prompt over three chunks and a
prefix-cache hit (tests/test_torch_checkpoint_serving.py holds the Qwen3
checkpoint and the helpers).
"""

import pytest

from test_torch_checkpoint_serving import BUILD, _short_scenarios, _streams


@pytest.mark.parametrize("layout", ["gemma3", "gpt_oss-mxfp4", "deepseek_v3"])
def test_family_checkpoint_streams_tpu_engine_tokens(tmp_path, layout):
    path = BUILD[layout](str(tmp_path / layout))
    want, got = _streams(path, "model", _short_scenarios)
    assert len(got["chunked"]["tokens"]) == 6
    assert got["repeat"]["second"]["cached"] > 0
    assert got == want
