"""The port's MLA forward against HuggingFace transformers'
DeepseekV3ForCausalLM: the tiny random checkpoint of
tests/test_mla_hf_parity.py (sigmoid routing with a non-zero balancing
bias, two expert groups, a shared expert, one dense layer), mapped to the
reference's parameter tree by the JAX package's loader; the tree goes
through numpy and ``params_from_numpy`` into the port. A second case
reads the checkpoint with the port's own loader instead. Logits within
2e-3, the reference test's tolerance (float32, eager attention in HF), and
the same argmax at every position, with the full-rank and the low-rank
query projection.
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
from dynamo_tpu_torch.models import mla as tmla  # noqa: E402
from dynamo_tpu_torch.ops import attention as tatt  # noqa: E402
from test_mla_hf_parity import _make_hf_checkpoint  # noqa: E402

TOL = 2e-3


@pytest.mark.parametrize("q_lora_rank", [None, 24])
def test_logits_match_hf_deepseek_v3(tmp_path, q_lora_rank):
    model, ckpt = _make_hf_checkpoint(tmp_path, q_lora_rank)
    jcfg = jweights.config_from_hf(ckpt)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    tcfg = tmla.MlaConfig(**dict(fields, dtype=torch.float32))
    assert tcfg.q_lora_rank == (q_lora_rank or 0) and tcfg.n_group == 2
    assert tcfg.num_kv_heads == 1 and tcfg.head_dim == 32 + 8
    tree = jax.tree.map(np.asarray, jweights.load_params(
        ckpt, dataclasses.replace(jcfg, dtype=np.float32)))
    params = params_from_numpy(tree, tcfg, device="cpu")
    bias = params["layers"][1]["router_bias"]
    assert bias.dtype == torch.float32 and float(bias.abs().sum()) > 0

    token_ids = np.array([5, 99, 23, 77, 1, 42, 17, 63, 8, 120, 3, 60], np.int64)
    with torch.no_grad():
        want = model(torch.tensor(token_ids)[None]).logits[0].numpy()
        hidden = tmla.forward(
            params, tcfg, torch.from_numpy(token_ids), torch.arange(len(token_ids)),
            lambda q, k, v, i: tatt.causal_attention(q, k, v))
        got = tmla.lm_logits(params, tcfg, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()


@pytest.mark.parametrize("q_lora_rank", [None, 24])
def test_logits_match_hf_deepseek_v3_through_the_port_loader(tmp_path, q_lora_rank):
    """The same checkpoint read by the port's own loader
    (``dynamo_tpu_torch.engine.weights.load_params``)."""
    model, ckpt = _make_hf_checkpoint(tmp_path, q_lora_rank)
    tcfg = dataclasses.replace(tweights.config_from_hf(ckpt), dtype=torch.float32)
    params = tweights.load_params(ckpt, tcfg, device="cpu")
    assert params["layers"][1]["router_bias"].dtype == torch.float32

    token_ids = np.array([5, 99, 23, 77, 1, 42, 17, 63, 8, 120, 3, 60], np.int64)
    with torch.no_grad():
        want = model(torch.tensor(token_ids)[None]).logits[0].numpy()
        hidden = tmla.forward(
            params, tcfg, torch.from_numpy(token_ids), torch.arange(len(token_ids)),
            lambda q, k, v, i: tatt.causal_attention(q, k, v))
        got = tmla.lm_logits(params, tcfg, hidden).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert (got.argmax(-1) == want.argmax(-1)).all()
