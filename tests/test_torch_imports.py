"""The port stands alone: no module of dynamo_tpu_torch, nor chip_smoke.py,
imports jax or anything of the dynamo_tpu package (not even its modules
that are free of JAX). Checked twice: statically over every import
statement, and by importing every module in a fresh interpreter and looking
at sys.modules. serve_compare.py (a GPU script that runs on import) is
checked statically."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "dynamo_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "dynamo_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _static_sources():
    return sorted(_sources() + [os.path.join(REPO, "serve_compare.py")])


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def _modules():
    mods = []
    for path in _sources():
        rel = os.path.relpath(path, REPO)[:-3]
        if rel == "chip_smoke":
            mods.append(rel)
            continue
        parts = rel.split(os.sep)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


@pytest.mark.parametrize("path", _static_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_forbidden_import_statement(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{path} imports {bad}"


def test_importing_every_module_loads_neither_jax_nor_the_reference():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(repr(bad))\n"
    )
    r = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO},
    )
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]", r.stdout


def test_the_walk_covers_every_module_of_the_port():
    """Both checks above walk the package; the modules of each slice must be
    in that walk (slice 2: int8 KV, block copy, KVBM; slice 3: the gemma
    family and the model registry; then the gpt-oss family; then the
    Qwen3-MoE and MLA families and the latent attention wrapper)."""
    mods = set(_modules())
    assert {
        "dynamo_tpu_torch.ops.quant", "dynamo_tpu_torch.ops.block_copy",
        "dynamo_tpu_torch.kvbm", "dynamo_tpu_torch.kvbm.layout",
        "dynamo_tpu_torch.kvbm.pool", "dynamo_tpu_torch.engine.engine",
        "dynamo_tpu_torch.engine.sampling", "dynamo_tpu_torch.run", "chip_smoke",
        "dynamo_tpu_torch.models.gemma", "dynamo_tpu_torch.models.registry",
        "dynamo_tpu_torch.models.gptoss", "dynamo_tpu_torch.models.moe",
        "dynamo_tpu_torch.models.mla", "dynamo_tpu_torch.models.experts",
        "dynamo_tpu_torch.ops.cuda_mla",
    } <= mods
