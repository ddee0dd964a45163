"""Model hub resolution: a model reference -> a local snapshot directory.

Counterpart of the reference's llm/hub.py. A reference resolves, in
precedence order, to:

  1. an existing local directory (used as it is);
  2. the HuggingFace cache layout under ``$DTPU_HUB_CACHE``, else
     ``$HF_HUB_CACHE``, else ``$HF_HOME/hub`` (default
     ``~/.cache/huggingface/hub``): ``models--{org}--{name}/snapshots/{rev}``,
     the revision from ``refs/main`` when present, else the newest snapshot;
  3. a download through ``huggingface_hub.snapshot_download`` (an optional
     package, imported only here), unless ``DTPU_HUB_OFFLINE`` (or
     ``HF_HUB_OFFLINE``) is set.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

log = logging.getLogger("dynamo_tpu_torch.llm.hub")


def hub_cache_dir() -> str:
    """The HF hub cache root, by the standard environment precedence."""
    if os.environ.get("DTPU_HUB_CACHE"):
        return os.environ["DTPU_HUB_CACHE"]
    if os.environ.get("HF_HUB_CACHE"):
        return os.environ["HF_HUB_CACHE"]
    hf_home = os.environ.get("HF_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache", "huggingface")
    return os.path.join(hf_home, "hub")


def _snapshot_from_cache(ref: str, cache: str) -> Optional[str]:
    """models--org--name/snapshots/<rev> for ``org/name``, or None."""
    repo_dir = os.path.join(cache, "models--" + ref.replace("/", "--"))
    snaps = os.path.join(repo_dir, "snapshots")
    if not os.path.isdir(snaps):
        return None
    rev: Optional[str] = None
    main_ref = os.path.join(repo_dir, "refs", "main")
    if os.path.isfile(main_ref):
        with open(main_ref) as f:
            rev = f.read().strip()
    if rev and os.path.isdir(os.path.join(snaps, rev)):
        return os.path.join(snaps, rev)
    revs = sorted(
        (os.path.getmtime(os.path.join(snaps, d)), d)
        for d in os.listdir(snaps)
        if os.path.isdir(os.path.join(snaps, d))
    )
    return os.path.join(snaps, revs[-1][1]) if revs else None


def _offline() -> bool:
    return os.environ.get(
        "DTPU_HUB_OFFLINE", os.environ.get("HF_HUB_OFFLINE", "0")
    ) not in ("0", "", "false")


def resolve_model_path(ref: str, cache_dir: Optional[str] = None) -> str:
    """Model reference (a path or ``org/name``) -> local snapshot directory.

    Raises FileNotFoundError with an actionable message when the reference
    is neither a directory, nor cached, nor downloadable (offline)."""
    if os.path.isdir(ref):
        return ref
    cache = cache_dir or hub_cache_dir()
    snap = _snapshot_from_cache(ref, cache)
    if snap is not None:
        log.info("resolved %s from hub cache: %s", ref, snap)
        return snap
    if not _offline():
        try:
            from huggingface_hub import snapshot_download  # optional package

            path = snapshot_download(ref, cache_dir=cache)
            log.info("downloaded %s -> %s", ref, path)
            return path
        except ImportError:
            raise FileNotFoundError(
                f"model {ref!r}: not a directory, not in hub cache {cache}, "
                f"and huggingface_hub is not installed — install it to "
                f"download, or pre-populate the cache / pass a local path"
            ) from None
        except Exception as e:
            raise FileNotFoundError(
                f"model {ref!r}: not a directory, not in hub cache {cache}, "
                f"and download failed: {e}"
            ) from e
    raise FileNotFoundError(
        f"model {ref!r}: not a directory and not in hub cache {cache} "
        f"(offline mode — pre-populate the cache or pass a local path)"
    )
