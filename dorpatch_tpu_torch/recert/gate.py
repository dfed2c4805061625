"""Serve-boot recert gate: refuse to serve silently-uncertified.

The serve worker consults the scheduler's published verdict
(`recert_verdict.json`) at boot, as the JAX package's AOT store boots
(`--aot strict` refuses on a cache miss; `--require-recert strict`
refuses on a failing or stale robustness verdict):

- ``off``    — no gate; the snapshot is still loaded for `GET /robustness`
  when a recert dir is configured.
- ``warn``   — boot proceeds on any verdict (including a missing one) and
  the degraded status is carried in the snapshot for `/robustness` and
  the boot log.
- ``strict`` — the pool refuses to reach serving-ready unless the verdict
  exists and its status is ``ok``: a DP400/DP401 finding (``failing``), a
  DP402 hole or unseeded baseline (``stale``), or no verdict at all
  (``absent``) each raise the typed `RecertGateError` instead of serving.

Port of `dorpatch_tpu.recert.gate`, the same modes, snapshot keys and
messages. Host-only: reads one JSON file, imports no torch. The port's
service runs the gate before it builds its victim or its defense bank, so
a strict refusal costs neither a CUDA context nor a kernel build.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

from dorpatch_tpu_torch.checkpoint import load_json

REQUIRE_MODES = ("off", "warn", "strict")


class RecertGateError(RuntimeError):
    """Strict recert gate refused the boot: the robustness verdict is
    failing, stale, or absent — serving would be silently-uncertified."""


def load_verdict(recert_dir: str) -> Optional[Dict[str, Any]]:
    from dorpatch_tpu_torch.recert.scheduler import VERDICT_NAME
    v = load_json(os.path.join(recert_dir, VERDICT_NAME))
    return v if isinstance(v, dict) else None


def snapshot(recert_dir: str, require: str = "off") -> Dict[str, Any]:
    """The robustness snapshot a serve worker carries: gate mode, verdict
    status (``absent`` when none is published), and the per-cell verdict
    body for `GET /robustness`."""
    verdict = load_verdict(recert_dir) if recert_dir else None
    status = verdict.get("status", "failing") if verdict else "absent"
    out: Dict[str, Any] = {
        "require": require,
        "recert_dir": os.path.abspath(recert_dir) if recert_dir else "",
        "status": status,
    }
    if verdict is not None:
        out["generation"] = verdict.get("generation")
        out["worst_margin"] = verdict.get("worst_margin")
        out["findings_by_rule"] = verdict.get("findings_by_rule", {})
        out["cells"] = verdict.get("cells", {})
    return out


def boot_gate(recert_dir: str, require: str = "off"
              ) -> Optional[Dict[str, Any]]:
    """Evaluate the gate at serve boot. Returns the snapshot (None when no
    recert dir is configured and the gate is off); raises `RecertGateError`
    under ``strict`` unless the verdict status is ``ok``."""
    if require not in REQUIRE_MODES:
        raise ValueError(
            f"require_recert must be one of {REQUIRE_MODES}, got {require!r}")
    if not recert_dir and require == "off":
        return None
    if not recert_dir:
        raise RecertGateError(
            f"--require-recert {require} needs a recert dir "
            "(--recert-dir) to read the verdict from")
    snap = snapshot(recert_dir, require)
    if require == "strict" and snap["status"] != "ok":
        failing = [c for c, cell in snap.get("cells", {}).items()
                   if cell.get("status") not in ("ok", "added")]
        raise RecertGateError(
            f"recert verdict is '{snap['status']}' "
            f"(generation {snap.get('generation', '?')}) under "
            f"--require-recert strict — refusing serving-ready; "
            f"cells: {', '.join(failing[:3]) or '(no verdict published)'}"
            + (" ..." if len(failing) > 3 else ""))
    return snap
