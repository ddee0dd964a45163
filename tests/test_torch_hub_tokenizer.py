"""Hub resolution (llm/hub.py), the HF tokenizer (llm/tokenizer.py) and
``run.py out=<checkpoint>`` against the reference package's.

Resolution: a directory, a cache snapshot through ``refs/main``, the
newest snapshot by mtime, the offline error and the missing-package error
(``sys.modules["huggingface_hub"] = None``), with the reference's results
and messages; no test reaches a network. The tokenizer is a real BPE
``tokenizers`` model trained in the test with a chat template, saved the
HF-fast way (the builder of tests/test_hub_checkpoint.py, copied).
"""

import asyncio
import json
import os
import subprocess
import sys
import time

import jax
import pytest

import torch_hf_ckpt as ck
from dynamo_tpu.engine import weights as jweights
from dynamo_tpu.engine.engine import TpuEngine, TpuEngineConfig
from dynamo_tpu.llm import hub as jhub
from dynamo_tpu.llm import tokenizer as jtok
from dynamo_tpu.llm.protocols.common import (
    PreprocessedRequest as JRequest,
    SamplingOptions as JSampling,
    StopConditions as JStop,
)
from dynamo_tpu.parallel.mesh import make_mesh
from dynamo_tpu.runtime import Context as JContext
from dynamo_tpu_torch.llm import hub as thub
from dynamo_tpu_torch.llm import tokenizer as ttok

pytest.importorskip("transformers")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = 256
CHAT_TEMPLATE = (
    "{% for message in messages %}"
    "<|{{ message['role'] }}|>{{ message['content'] }}"
    "{% endfor %}{% if add_generation_prompt %}<|assistant|>{% endif %}"
)


def build_tokenizer(path: str) -> None:
    """A real trained BPE tokenizer (tiny corpus) with a chat template."""
    from tokenizers import Tokenizer
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    os.makedirs(path, exist_ok=True)
    tok = Tokenizer(BPE(unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    trainer = BpeTrainer(
        vocab_size=VOCAB,
        special_tokens=["<unk>", "<s>", "</s>", "<|user|>", "<|assistant|>"],
    )
    corpus = ["hello world how are you today",
              "the quick brown fox jumps over the lazy dog",
              "tell me a story about chips serving tokens"]
    tok.train_from_iterator(corpus, trainer)
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({
            "tokenizer_class": "PreTrainedTokenizerFast",
            "unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>",
            "chat_template": CHAT_TEMPLATE,
        }, f)


@pytest.fixture
def offline(monkeypatch):
    monkeypatch.setenv("DTPU_HUB_OFFLINE", "1")


def _both(fn_name, *args, **kw):
    """The port's and the reference's result (or error message)."""
    out = []
    for mod in (thub, jhub):
        try:
            out.append(getattr(mod, fn_name)(*args, **kw))
        except FileNotFoundError as e:
            out.append(("error", str(e)))
    return out


def test_a_directory_resolves_to_itself(tmp_path, offline):
    d = tmp_path / "ckpt"
    d.mkdir()
    got, want = _both("resolve_model_path", str(d))
    assert got == want == str(d)


def test_a_cache_snapshot_resolves_through_refs_main(tmp_path, offline):
    repo = tmp_path / "hub" / "models--acme--tiny-llama"
    for rev in ("abc123", "zzz999"):
        (repo / "snapshots" / rev).mkdir(parents=True)
    (repo / "refs").mkdir()
    (repo / "refs" / "main").write_text("abc123\n")
    got, want = _both("resolve_model_path", "acme/tiny-llama", cache_dir=str(tmp_path / "hub"))
    assert got == want == str(repo / "snapshots" / "abc123")


def test_without_refs_main_the_newest_snapshot_wins(tmp_path, offline):
    snaps = tmp_path / "hub" / "models--acme--tiny" / "snapshots"
    now = time.time()
    for rev, age in (("new", 0), ("old", 100), ("mid", 50)):
        (snaps / rev).mkdir(parents=True)
        os.utime(snaps / rev, (now - age, now - age))
    got, want = _both("resolve_model_path", "acme/tiny", cache_dir=str(tmp_path / "hub"))
    assert got == want == str(snaps / "new")


def test_offline_miss_is_an_actionable_error(tmp_path, offline):
    got, want = _both("resolve_model_path", "acme/absent", cache_dir=str(tmp_path))
    assert got == want and got[0] == "error" and "offline mode" in got[1]


def test_online_miss_without_huggingface_hub_names_the_package(tmp_path, monkeypatch):
    monkeypatch.delenv("DTPU_HUB_OFFLINE", raising=False)
    monkeypatch.delenv("HF_HUB_OFFLINE", raising=False)
    monkeypatch.setitem(sys.modules, "huggingface_hub", None)
    got, want = _both("resolve_model_path", "acme/absent", cache_dir=str(tmp_path))
    assert got == want and "huggingface_hub is not installed" in got[1]


def test_hub_cache_dir_precedence(monkeypatch, tmp_path):
    for var in ("DTPU_HUB_CACHE", "HF_HUB_CACHE", "HF_HOME"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("HOME", str(tmp_path))
    steps = [("HF_HOME", str(tmp_path / "hf")), ("HF_HUB_CACHE", str(tmp_path / "hc")),
             ("DTPU_HUB_CACHE", str(tmp_path / "dc"))]
    seen = [thub.hub_cache_dir()]
    assert seen[0] == jhub.hub_cache_dir() == str(tmp_path / ".cache" / "huggingface" / "hub")
    for var, val in steps:
        monkeypatch.setenv(var, val)
        assert thub.hub_cache_dir() == jhub.hub_cache_dir()
        seen.append(thub.hub_cache_dir())
    assert seen[1:] == [str(tmp_path / "hf" / "hub"), str(tmp_path / "hc"),
                        str(tmp_path / "dc")]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tok"))
    build_tokenizer(d)
    return d


def test_hf_tokenizer_matches_the_reference(tok_dir):
    t, j = ttok.HFTokenizer(tok_dir), jtok.HFTokenizer(tok_dir)
    assert (t.eos_token_id, t.bos_token_id, t.vocab_size) == (
        j.eos_token_id, j.bos_token_id, j.vocab_size)
    text = "hello world tell me a story about the lazy dog"
    ids = t.encode(text)
    assert ids == j.encode(text) and len(ids) > 3
    for skip in (True, False):
        ext = [t.bos_token_id] + ids + [t.eos_token_id]
        assert t.decode(ext, skip_special_tokens=skip) == j.decode(ext, skip_special_tokens=skip)
    msgs = [{"role": "user", "content": "hello"}, {"role": "assistant", "content": "world"},
            {"role": "user", "content": "how are you"}]
    for gen in (True, False):
        assert t.apply_chat_template(msgs, gen) == j.apply_chat_template(msgs, gen)
    assert t.apply_chat_template(msgs).endswith("<|assistant|>")
    assert t.encode_chat(msgs) == j.encode_chat(msgs)


def test_load_tokenizer_picks_by_reference(tok_dir, tmp_path):
    for ref in (None, "byte"):
        assert isinstance(ttok.load_tokenizer(ref), ttok.ByteTokenizer)
    hf = ttok.load_tokenizer(tok_dir)
    assert isinstance(hf, ttok.HFTokenizer) and hf.encode("hello") == jtok.load_tokenizer(
        tok_dir).encode("hello")
    missing = str(tmp_path / "absent")
    assert isinstance(ttok.load_tokenizer(missing), ttok.ByteTokenizer)
    assert type(jtok.load_tokenizer(missing)).__name__ == "ByteTokenizer"


def test_decode_stream_over_the_hf_tokenizer(tok_dir):
    tok = ttok.HFTokenizer(tok_dir)
    ids = tok.encode("the quick brown fox jumps over the lazy dog")
    stream = ttok.DecodeStream(tok)
    text = "".join(stream.step([i]) for i in ids) + stream.flush()
    assert text == tok.decode(ids) and "fox" in text
    ref = jtok.DecodeStream(jtok.HFTokenizer(tok_dir))
    assert "".join(ref.step([i]) for i in ids) + ref.flush() == text


def test_run_cli_serves_a_checkpoint_with_its_tokenizer(tok_dir, tmp_path):
    """``run.py out=<dir>`` prints the decoded greedy tokens of TpuEngine
    on the same checkpoint (the prompt: BOS, then the prompt's ids)."""
    ckpt = ck.llama(str(tmp_path / "ckpt"), "qwen3", tie=True, vocab=VOCAB)
    for f in os.listdir(tok_dir):
        with open(os.path.join(tok_dir, f)) as src, open(os.path.join(ckpt, f), "w") as dst:
            dst.write(src.read())
    tok = ttok.HFTokenizer(ckpt)
    prompt = [tok.bos_token_id] + tok.encode("hello world")
    jcfg = jweights.config_from_hf(ckpt)

    async def reference():
        engine = TpuEngine(
            TpuEngineConfig(model=jcfg, use_pallas=False, max_context=256, num_blocks=512,
                            prefill_buckets=(64, 128, 256)),
            params=jweights.load_params(ckpt, jcfg),
            mesh=make_mesh(tp=1, devices=jax.devices()[:1]))
        req = JRequest(request_id="r", model="m", token_ids=prompt,
                       stop=JStop(max_tokens=4, stop_token_ids=[tok.eos_token_id]),
                       sampling=JSampling(temperature=0.0))
        try:
            return [t async for o in engine.generate(req, JContext()) for t in o.token_ids]
        finally:
            engine.stop()

    ids = asyncio.run(reference())
    env = {**os.environ, "PYTHONPATH": REPO, "DTPU_WARM_CACHE": str(tmp_path / "warm"),
           "DTPU_HUB_OFFLINE": "1"}
    r = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.run", "in=text:hello world",
                        f"out={ckpt}", "--device", "cpu", "--max-tokens", "4",
                        "--max-context", "256"], cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert len(ids) >= 1
    assert r.stdout == tok.decode(ids) + "\n"
    assert len(os.listdir(tmp_path / "warm")) == 1   # loaded through the warm cache
