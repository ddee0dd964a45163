"""The port's weight owner (dynamo_tpu_torch/engine/weight_service.py)
against the reference's tests/test_weight_service.py, on the CPU.

- The reference's five cases on the port: an import equals the direct load
  bit for bit and outlives the checkpoint's deletion, live references
  refuse eviction; a SIGKILLed importer's references come back; an import
  from the owner's shared files beats a parse of the checkpoint; without
  an owner the loader falls back to the warm cache; the owner's command
  line serves imports and shuts down over the wire.
- Across packages: the two owners publish their warm-cache layouts, which
  differ on purpose (engine/warm.py: raw bytes and a package tag, where
  the reference writes ``.npy`` files), so each package's client refuses
  the other's owner with an error instead of loading wrong tensors.
"""

import asyncio
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from dynamo_tpu.engine import weight_service as jws
from dynamo_tpu_torch.engine import weight_service as tws
from dynamo_tpu_torch.engine.warm import _flatten
from dynamo_tpu_torch.engine.weights import config_from_hf, load_params
from test_hub_checkpoint import build_checkpoint
from test_weight_service import _build_big_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bit_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k


async def test_import_matches_direct_load_and_survives_source_deletion(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    build_checkpoint(ckpt)
    cfg = config_from_hf(ckpt)
    direct = load_params(ckpt, cfg, "cpu")
    sock = str(tmp_path / "wo.sock")
    owner = await tws.WeightOwner(sock, root=str(tmp_path / "shm")).start()
    try:
        c1 = await asyncio.to_thread(tws.WeightServiceClient, sock)
        params, info = await asyncio.to_thread(c1.import_params, ckpt, cfg, "cpu")
        _bit_equal(params, direct)
        assert info["refs"] == 1
        # the checkpoint gone: imports go on (the owner holds the weights)
        import shutil

        shutil.rmtree(ckpt)
        c2 = await asyncio.to_thread(tws.WeightServiceClient, sock)
        params2, info2 = await asyncio.to_thread(c2.import_params, ckpt, cfg, "cpu")
        _bit_equal(params2, direct)
        assert info2["refs"] == 2
        with pytest.raises(RuntimeError, match="live references"):
            await asyncio.to_thread(c1.evict, ckpt)
        await asyncio.to_thread(c1.release, ckpt)
        await asyncio.to_thread(c2.release, ckpt)
        await asyncio.to_thread(c2.evict, ckpt)
        assert await asyncio.to_thread(c1.stat) == []
        c1.close()
        c2.close()
    finally:
        await owner.stop()


async def test_sigkill_worker_returns_lease(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    build_checkpoint(ckpt)
    sock = str(tmp_path / "wo.sock")
    owner = await tws.WeightOwner(sock, root=str(tmp_path / "shm")).start()
    try:
        code = f"""
import sys, time
sys.path.insert(0, {json.dumps(REPO)})
from dynamo_tpu_torch.engine.weight_service import WeightServiceClient
c = WeightServiceClient({json.dumps(sock)})
params, info = c.import_params({json.dumps(ckpt)}, None, "cpu")
print("IMPORTED", info["refs"], flush=True)
time.sleep(600)
"""
        proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE)
        try:
            line = await asyncio.wait_for(asyncio.to_thread(proc.stdout.readline), 120)
            assert b"IMPORTED" in line, proc.stderr.read().decode()
            admin = await asyncio.to_thread(tws.WeightServiceClient, sock)
            assert (await asyncio.to_thread(admin.stat))[0]["refs"] == 1
        finally:
            proc.kill()
            proc.wait()
        for _ in range(100):
            sets = await asyncio.to_thread(admin.stat)
            if sets[0]["refs"] == 0:
                break
            await asyncio.sleep(0.05)
        assert sets[0]["refs"] == 0
        admin.close()
    finally:
        await owner.stop()


async def test_shm_restore_beats_disk_reload(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    _build_big_checkpoint(ckpt)
    cfg = config_from_hf(ckpt)
    sock = str(tmp_path / "wo.sock")
    owner = await tws.WeightOwner(sock, root=str(tmp_path / "shm")).start()
    try:
        c = await asyncio.to_thread(tws.WeightServiceClient, sock)
        await asyncio.to_thread(c.import_params, ckpt, cfg, "cpu")   # the owner parses once
        t0 = time.perf_counter()
        disk = load_params(ckpt, cfg, "cpu")
        t_disk = time.perf_counter() - t0

        def respawn_import():
            cc = tws.WeightServiceClient(sock)
            t1 = time.perf_counter()
            params, _ = cc.import_params(ckpt, cfg, "cpu")
            dt = time.perf_counter() - t1
            cc.close()
            return params, dt

        params, t_shm = await asyncio.to_thread(respawn_import)
        _bit_equal(params, disk)
        assert t_disk > 0.02, f"checkpoint too small to measure ({t_disk})"
        assert t_shm < t_disk, (t_shm, t_disk)
        c.close()
    finally:
        await owner.stop()


async def test_load_params_served_falls_back_without_owner(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "ckpt")
    build_checkpoint(ckpt)
    cfg = config_from_hf(ckpt)
    monkeypatch.setenv("DTPU_WARM_CACHE", str(tmp_path / "warm"))
    params, lease = tws.load_params_served(ckpt, cfg, sock_path=str(tmp_path / "missing.sock"),
                                           device="cpu")
    assert lease is None and "layers" in params
    _bit_equal(params, load_params(ckpt, cfg, "cpu"))


async def test_cli_owner_process_serves_imports(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    build_checkpoint(ckpt)
    sock = str(tmp_path / "wo.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dynamo_tpu_torch.engine.weight_service", "--sock", sock,
         "--root", str(tmp_path / "shm"), "--preload", ckpt],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        lines = []
        while True:
            line = await asyncio.wait_for(asyncio.to_thread(proc.stdout.readline), 120)
            assert line, "".join(lines)
            lines.append(line)
            if line.startswith(tws.READY):
                break
        assert any(ln.startswith("WEIGHT_OWNER_SHM ") for ln in lines)
        assert any(ln.startswith(f"WEIGHT_OWNER_LOADED {ckpt} bytes=") for ln in lines)
        c = await asyncio.to_thread(tws.WeightServiceClient, sock)
        params, info = await asyncio.to_thread(c.import_params, ckpt, None, "cpu")
        assert info["bytes"] > 0 and info["refs"] == 1   # the preload's set
        _bit_equal(params, load_params(ckpt, None, "cpu"))
        c.shutdown_owner()
        c.close()
        assert await asyncio.to_thread(proc.wait, 30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.mark.parametrize("owner_pkg", ["reference", "port"])
async def test_each_client_refuses_the_other_packages_owner(tmp_path, owner_pkg):
    """The warm layouts differ (ROADMAP Queue 3): a port client importing
    from a reference owner gets a ValueError naming the package, and a
    reference client importing from a port owner fails to read the raw
    files; neither loads tensors."""
    ckpt = str(tmp_path / "ckpt")
    build_checkpoint(ckpt)
    sock = str(tmp_path / "wo.sock")
    owner_mod, client_mod = (jws, tws) if owner_pkg == "reference" else (tws, jws)
    owner = await owner_mod.WeightOwner(sock, root=str(tmp_path / "shm")).start()
    c = None
    try:
        c = await asyncio.to_thread(client_mod.WeightServiceClient, sock)
        if owner_pkg == "reference":
            with pytest.raises(ValueError, match="not an entry of this package's cache"):
                await asyncio.to_thread(c.import_params, ckpt, None, "cpu")
        else:
            with pytest.raises((ValueError, OSError)):
                await asyncio.to_thread(c.import_params, ckpt, None)
        # the owner parsed the checkpoint into its own layout all the same
        assert (await asyncio.to_thread(c.stat))[0]["refs"] == 1
    finally:
        if c is not None:
            c.close()   # an owner's stop waits for its connections
        await owner.stop()


def test_configs_cross_the_socket_unchanged():
    """An importer's config reaches the owner as the same dataclass (dtype
    and tuple fields too), so that both key the same warm entry."""
    from dynamo_tpu_torch.models.gemma import GemmaConfig
    from dynamo_tpu_torch.models.llama import LlamaConfig

    for cfg in (LlamaConfig.tiny(), GemmaConfig.tiny(), LlamaConfig(dtype=torch.float32)):
        back = tws._cfg_from_obj(json.loads(json.dumps(tws._cfg_to_obj(cfg))))
        assert back == cfg and repr(back) == repr(cfg)
