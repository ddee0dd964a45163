"""The port's gpt-oss forward against HuggingFace transformers'
GptOssForCausalLM: a tiny random model built from a config written in
code (tests/test_gptoss_parity.py's, with non-zero sinks and biases, YaRN
on and off), saved as a checkpoint and mapped to the reference's parameter
tree by the JAX package's loader; the tree goes through numpy and
``params_from_numpy`` into the port. A second case reads the checkpoint
with the port's own loader instead. Logits
within 2e-3, the reference test's tolerance (float32, eager attention in
HF), and the same argmax at every position.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

pytest.importorskip("transformers")

from dynamo_tpu.engine import weights as jweights  # noqa: E402
from dynamo_tpu_torch.engine import weights as tweights  # noqa: E402
from dynamo_tpu_torch.engine.weights import params_from_numpy  # noqa: E402
from dynamo_tpu_torch.models import gptoss as tgptoss  # noqa: E402
from dynamo_tpu_torch.ops import attention as tatt  # noqa: E402
from test_gptoss_parity import _make_ckpt  # noqa: E402

TOL = 2e-3


@pytest.mark.parametrize("yarn", [False, True], ids=["plain", "yarn"])
def test_logits_match_hf_gptoss(tmp_path, yarn):
    model, ckpt = _make_ckpt(tmp_path, yarn)
    jcfg = jweights.config_from_hf(ckpt)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = tgptoss.GptOssConfig(**dict(fields, dtype=torch.float32))
    assert tcfg.window_for_layer(0) == 8 and tcfg.window_for_layer(1) is None
    assert (tcfg.rope_scaling_factor > 1) == yarn
    tree = jax.tree.map(np.asarray, jweights.load_params(
        ckpt, dataclasses.replace(jcfg, dtype=np.float32)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    assert params["layers"][0]["sinks"].dtype == torch.float32
    assert float(params["layers"][0]["sinks"].abs().sum()) > 0

    token_ids = np.array([5, 99, 23, 77, 1, 42, 17, 63, 8, 120, 3, 60], np.int64)
    with torch.no_grad():
        want = model(torch.tensor(token_ids)[None]).logits[0].numpy()
        hidden = tgptoss.forward(
            params, tcfg, torch.from_numpy(token_ids), torch.arange(len(token_ids)),
            lambda q, k, v, i, **kw: tatt.causal_attention(q, k, v, **kw))
        got = tgptoss.lm_logits(params, tcfg, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("yarn", [False, True], ids=["plain", "yarn"])
def test_logits_match_hf_gptoss_through_the_port_loader(tmp_path, yarn):
    """The same checkpoint read by the port's own loader
    (``dynamo_tpu_torch.engine.weights.load_params``)."""
    model, ckpt = _make_ckpt(tmp_path, yarn)
    tcfg = dataclasses.replace(tweights.config_from_hf(ckpt), dtype=torch.float32)
    params = tweights.load_params(ckpt, tcfg, device="cpu")
    assert params["layers"][0]["sinks"].dtype == torch.float32

    token_ids = np.array([5, 99, 23, 77, 1, 42, 17, 63, 8, 120, 3, 60], np.int64)
    with torch.no_grad():
        want = model(torch.tensor(token_ids)[None]).logits[0].numpy()
        hidden = tgptoss.forward(
            params, tcfg, torch.from_numpy(token_ids), torch.arange(len(token_ids)),
            lambda q, k, v, i, **kw: tatt.causal_attention(q, k, v, **kw))
        got = tgptoss.lm_logits(params, tcfg, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
