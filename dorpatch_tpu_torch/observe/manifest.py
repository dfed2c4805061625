"""Run manifest: `run.json` makes every results dir self-describing.

`config.json` (artifacts.write_config_record) records WHAT was asked for;
`run.json` records what actually RAN it — library versions, device kind and
topology, process count, hostname, git SHA — plus the per-attempt `run_id`
that stamps every metrics/events/heartbeat record. Resumed runs overwrite
`run.json` with the newest attempt but chain the older ids into
`previous_run_ids`, so the report CLI can enumerate attempts even before
reading the JSONL files.

Port of `dorpatch_tpu.observe.manifest`. Host-only by construction:
nothing here imports torch at module level; `torch_environment()` (which
reads the live backend) is passed as `extra` by code that owns the card.
"""

from __future__ import annotations

import dataclasses
import json
import os
import platform
import socket
import subprocess
import sys
import time
import uuid
from typing import Optional

MANIFEST_NAME = "run.json"


def new_run_id() -> str:
    """Per-process, per-attempt id stamped onto every telemetry record."""
    return uuid.uuid4().hex[:12]


def new_trace_id() -> str:
    """Per-REQUEST correlation id, minted once at ingress (the HTTP
    request) and carried by every telemetry record the request touches —
    one query is one joinable identity across `events.jsonl` files."""
    return uuid.uuid4().hex[:16]


def git_sha() -> Optional[str]:
    """Best-effort SHA of the checkout this package runs from."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        out = subprocess.run(
            ["git", "-C", root, "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5)
    except (OSError, subprocess.SubprocessError):
        return None
    sha = out.stdout.strip()
    return sha if out.returncode == 0 and sha else None


def torch_environment() -> dict:
    """Backend/device blurb for the manifest (the JAX package's
    `jax_environment`, the same keys where they apply): `backend_impl`
    "torch", the torch and CUDA versions and, where there is a card, the
    device kind and count."""
    import torch

    info = {"backend_impl": "torch", "torch": torch.__version__,
            "cuda": torch.version.cuda}
    try:
        cuda = torch.cuda.is_available()
        info.update({
            "backend": "cuda" if cuda else "cpu",
            "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "device_count": torch.cuda.device_count() if cuda else 0,
            "local_device_count": torch.cuda.device_count() if cuda else 0,
            "process_count": 1,
            "process_index": 0,
        })
    except Exception as e:  # backend refused to come up: record why
        info["backend_error"] = repr(e)
    return info


def run_manifest(cfg=None, run_id: str = "", extra: Optional[dict] = None,
                 clock=time.time) -> dict:
    """Assemble the manifest dict (pure; `write_run_manifest` persists it)."""
    m = {
        "schema": 1,
        "run_id": run_id,
        "started_ts": round(clock(), 3),
        "started_iso": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        "hostname": socket.gethostname(),
        "pid": os.getpid(),
        "platform": platform.platform(),
        "python": sys.version.split()[0],
        "argv": list(sys.argv),
    }
    sha = git_sha()
    if sha:
        m["git_sha"] = sha
    if cfg is not None:
        m["config"] = (dataclasses.asdict(cfg)
                       if dataclasses.is_dataclass(cfg) else dict(cfg))
    if extra:
        m.update(extra)
    return m


def write_run_manifest(result_dir: str, cfg=None, run_id: str = "",
                       extra: Optional[dict] = None) -> Optional[str]:
    """Write `run.json` at experiment start; returns its path (None when the
    results dir is read-only — telemetry must never fail the run). A prior
    manifest's run_id is chained into `previous_run_ids`."""
    path = os.path.join(result_dir, MANIFEST_NAME)
    previous = []
    try:
        with open(path) as fh:
            old = json.load(fh)
        previous = [old["run_id"]] if old.get("run_id") else []
        previous += list(old.get("previous_run_ids", []))
    except (OSError, ValueError, KeyError):
        pass
    m = run_manifest(cfg, run_id=run_id, extra=extra)
    if previous:
        m["previous_run_ids"] = previous
    try:
        os.makedirs(result_dir, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(m, fh, indent=1, default=float)
    except OSError:
        return None
    return path
