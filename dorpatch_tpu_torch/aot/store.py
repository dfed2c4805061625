"""Content-addressed on-disk store of the port's executables.

Port of `dorpatch_tpu.aot.store`. Layout under ``store_dir``:

    manifest.json                      deterministic index (atomic writes)
    blobs/libdorpatch_kernels_<h>.so   the kernel library (sha-verified)
    blobs/<name>-<sha>.bin             a serialized payload, for a method
                                       that has one (none of the port's)

What the port compiles is its kernel library (`ops/_build.py`, `nvcc`); a
program's executable is a CUDA graph captured from it at boot, which no
file can hold. So an entry records how the program materializes — method
`cuda_graph` (captured, replays bit-equal to the eager call) or `eager`
(with the reason it could not be captured) — and the seconds of its cold
first call and capture: the JAX store's "no blob, re-materialize at boot"
case (its `persistent_cache`), with capture in place of compile.

An entry's key is the program baseline's record — the fingerprint of the
program's canonical graph plus its interface hash
(`analysis/baseline.py`) — combined with the environment the store was
built under (torch and CUDA versions, backend, device topology, the
kernel sources' hash). A lookup misses with a typed reason rather than
ever returning an entry for another program or world: ``absent``,
``fingerprint``, ``interface``, ``topology``, ``corrupt``.

The manifest is read tolerantly: a torn or garbage file behaves as an
empty store (every lookup misses ``absent``), as `checkpoint.load_json`
reads: boot falls back to building, never crashes on bad persisted state.
"""

from __future__ import annotations

import fnmatch
import hashlib
import os
import re
import shutil
from typing import Any, Dict, List, Optional, Tuple

from dorpatch_tpu_torch.checkpoint import atomic_write_json, load_json

MANIFEST = "manifest.json"
STORE_VERSION = 1

#: env keys that must match for any entry of the store to be servable; a
#: mismatch in any of them is the single miss reason "topology" (the store
#: was built for another world, whichever axis moved)
_ENV_KEYS = ("torch", "cuda", "backend", "topology", "kernels")

#: methods whose executable is re-materialized at boot: no blob
_NO_BLOB = ("persistent_cache", "cuda_graph", "eager")

#: the manifest's pseudo-entry name for the kernel library
KERNELS = "<kernels>"


def _backend(device=None) -> str:
    import torch

    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


def topology_hash(device=None) -> str:
    """16-hex digest over the visible devices: their count, the world size
    of the process group (1 without one), and each device's name and
    compute capability. Two hosts with one digest can share a store;
    anything else must rebuild."""
    import torch

    world = 1
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        world = torch.distributed.get_world_size()
    devs: List[str] = []
    if _backend(device) == "cuda":
        for i in range(torch.cuda.device_count()):
            major, minor = torch.cuda.get_device_capability(i)
            devs.append(f"{torch.cuda.get_device_name(i)}:{major}.{minor}")
    txt = "|".join([str(len(devs)), str(world)] + sorted(devs))
    return hashlib.sha256(txt.encode()).hexdigest()[:16]


def kernels_hash() -> str:
    """The kernel sources' hash, the one in the library's file name."""
    from dorpatch_tpu_torch.ops import _build

    return _build.library_path().stem.rsplit("_", 1)[-1]


def current_env(device=None) -> Dict[str, Any]:
    import torch

    return {
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": _backend(device),
        "topology": topology_hash(device),
        "kernels": kernels_hash(),
        "device_count": (torch.cuda.device_count()
                         if _backend(device) == "cuda" else 0),
    }


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()[:16]


def _file_sha(path: str) -> Optional[str]:
    h = hashlib.sha256()
    try:
        with open(path, "rb") as fh:
            for block in iter(lambda: fh.read(1 << 20), b""):
                h.update(block)
    except OSError:
        return None
    return h.hexdigest()[:16]


def _slug(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9._-]", "_", name)


class ExecutableStore:
    """Open (or create) an executable store rooted at ``store_dir``.

    ``check_env=True`` compares the manifest's recorded build environment
    against the live one (for ``device``: "cuda" when a card is visible)
    at open; on mismatch every lookup misses with reason ``topology``
    until the first `put` resets the store to the live environment (a
    rewrite under a new topology starts from a clean slate: entries built
    for the old world are unservable here by definition).
    """

    def __init__(self, store_dir: str, check_env: bool = True, device=None):
        self.store_dir = os.path.abspath(store_dir)
        self.blob_dir = os.path.join(self.store_dir, "blobs")
        self.manifest_path = os.path.join(self.store_dir, MANIFEST)
        self.device = device
        raw = load_json(self.manifest_path, default=None)
        if not isinstance(raw, dict) or not isinstance(
                raw.get("entries"), dict):
            raw = {"version": STORE_VERSION, "env": None, "entries": {}}
        self.manifest: Dict[str, Any] = raw
        self.env_reason: Optional[str] = None
        if check_env and self.manifest.get("entries"):
            env = self.manifest.get("env") or {}
            live = current_env(device)
            if any(env.get(k) != live.get(k) for k in _ENV_KEYS):
                self.env_reason = "topology"

    # ------------------------------------------------------------- entries

    def entries(self) -> Dict[str, Dict[str, Any]]:
        return self.manifest.get("entries", {})

    def _blob_path(self, entry: Dict[str, Any]) -> str:
        return os.path.join(self.store_dir, entry.get("payload", ""))

    def _read_payload(
        self, entry: Dict[str, Any]
    ) -> Tuple[Optional[bytes], Optional[str]]:
        if entry.get("method") in _NO_BLOB:
            # no blob: the executable is captured (or run) at boot
            return b"", None
        try:
            with open(self._blob_path(entry), "rb") as fh:
                payload = fh.read()
        except OSError:
            return None, "corrupt"
        if _sha(payload) != entry.get("payload_sha"):
            return None, "corrupt"
        return payload, None

    def lookup(
        self, name: str, fingerprint: str, interface_sha: str = ""
    ) -> Tuple[Optional[bytes], Optional[Dict[str, Any]], Optional[str]]:
        """Return (payload, entry, miss_reason); miss_reason None on hit."""
        if self.env_reason:
            return None, None, self.env_reason
        entry = self.entries().get(name)
        if entry is None:
            return None, None, "absent"
        if entry.get("fingerprint") != fingerprint:
            return None, entry, "fingerprint"
        if (
            interface_sha
            and entry.get("interface_sha")
            and entry.get("interface_sha") != interface_sha
        ):
            return None, entry, "interface"
        payload, reason = self._read_payload(entry)
        if reason is not None:
            return None, entry, reason
        return payload, entry, None

    def lookup_by_fingerprint(
        self, fingerprint: str, interface_sha: str = ""
    ) -> Tuple[Optional[bytes], Optional[Dict[str, Any]], Optional[str]]:
        """Content-addressed lookup ignoring the entry name: the farm's
        lazy first-call resolver, where the live timer name need not match
        the registry name the store was built under."""
        if self.env_reason:
            return None, None, self.env_reason
        for name in sorted(self.entries()):
            entry = self.entries()[name]
            if entry.get("fingerprint") != fingerprint:
                continue
            if (
                interface_sha
                and entry.get("interface_sha")
                and entry.get("interface_sha") != interface_sha
            ):
                continue
            payload, reason = self._read_payload(entry)
            if reason is None:
                return payload, entry, None
        return None, None, "absent"

    def put(
        self,
        name: str,
        fingerprint: str,
        interface_sha: str,
        method: str,
        payload: bytes,
        build_compile_s: float,
        **extra: Any,
    ) -> Dict[str, Any]:
        """Write/overwrite one entry (blob immediately, manifest on
        save()). `extra` (the port's `capture_s`, `reason`, ...) lands in
        the entry beside the JAX store's keys."""
        self._restart_if_foreign()
        os.makedirs(self.blob_dir, exist_ok=True)
        entry: Dict[str, Any] = {
            "fingerprint": fingerprint,
            "interface_sha": interface_sha,
            "method": method,
            "payload": "",
            "payload_sha": "",
            "payload_bytes": 0,
            "build_compile_s": round(float(build_compile_s), 6),
        }
        entry.update(extra)
        if method not in _NO_BLOB:
            rel = os.path.join(
                "blobs", f"{_slug(name)}-{_sha(name.encode())[:10]}.bin"
            )
            path = os.path.join(self.store_dir, rel)
            tmp = f"{path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as fh:
                fh.write(payload)
            os.replace(tmp, path)
            entry.update(
                payload=rel,
                payload_sha=_sha(payload),
                payload_bytes=len(payload),
            )
        self.manifest.setdefault("entries", {})[name] = entry
        return entry

    def _restart_if_foreign(self) -> None:
        if self.env_reason:
            # rebuilding under a different environment: the old entries
            # are unservable here, so start clean under the live env
            self.manifest = {
                "version": STORE_VERSION,
                "env": None,
                "entries": {},
            }
            self.env_reason = None

    def remove(self, name: str) -> bool:
        entry = self.entries().pop(name, None)
        if entry is None:
            return False
        if entry.get("payload"):
            try:
                os.remove(self._blob_path(entry))
            except OSError:
                pass
        return True

    def save(self) -> None:
        """Atomically persist the manifest, stamping the live environment."""
        os.makedirs(self.store_dir, exist_ok=True)
        if self.manifest.get("env") is None:
            self.manifest["env"] = current_env(self.device)
        self.manifest["version"] = STORE_VERSION
        self.manifest["entries"] = {
            k: self.manifest["entries"][k]
            for k in sorted(self.manifest.get("entries", {}))
        }
        atomic_write_json(self.manifest_path, self.manifest)

    # ------------------------------------------------------ kernel library

    def kernels(self) -> Optional[Dict[str, Any]]:
        """The kernel library's record, or None."""
        rec = self.manifest.get("kernels")
        return rec if isinstance(rec, dict) else None

    def kernels_blob(self) -> Tuple[Optional[str], Optional[str]]:
        """(path of the library blob, miss reason): ``absent`` without a
        record or for other sources than the live ones, ``corrupt`` when
        the blob is missing or fails its sha."""
        rec = self.kernels()
        if rec is None or rec.get("hash") != kernels_hash():
            return None, "absent"
        path = os.path.join(self.store_dir, rec.get("payload", ""))
        if _file_sha(path) != rec.get("payload_sha"):
            return None, "corrupt"
        return path, None

    def put_kernels(self, library: str) -> Dict[str, Any]:
        """Copy the built library `library` into blobs/ (atomic) and record
        it; the manifest is written on save()."""
        self._restart_if_foreign()
        os.makedirs(self.blob_dir, exist_ok=True)
        rel = os.path.join("blobs", os.path.basename(library))
        path = os.path.join(self.store_dir, rel)
        tmp = f"{path}.{os.getpid()}.tmp"
        shutil.copyfile(library, tmp)
        os.replace(tmp, path)
        rec = {"hash": kernels_hash(), "payload": rel,
               "payload_sha": _file_sha(path),
               "payload_bytes": os.path.getsize(path)}
        self.manifest["kernels"] = rec
        return rec

    # ------------------------------------------------------------ lifecycle

    def state_hash(self) -> str:
        """16-hex digest over (name, fingerprint, payload_sha) triples: the
        store's identity, stamped next to the program set's hash."""
        lines = [
            f"{n}:{e.get('fingerprint')}:{e.get('payload_sha')}"
            for n, e in sorted(self.entries().items())
        ]
        return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]

    def gc(self, baseline_entries: Dict[str, Any]) -> List[str]:
        """Drop entries whose name or fingerprint has left baselines.json,
        plus orphaned blobs (a kernel library of other sources included);
        returns the removed entry names."""
        removed = []
        for name in sorted(self.entries()):
            entry = self.entries()[name]
            base = baseline_entries.get(name)
            if base is None or base.get("fingerprint") != entry.get(
                "fingerprint"
            ):
                self.remove(name)
                removed.append(name)
        live_blobs = {
            e.get("payload")
            for e in self.entries().values()
            if e.get("payload")
        }
        rec = self.kernels()
        if rec is not None and rec.get("hash") == kernels_hash():
            live_blobs.add(rec.get("payload"))
        elif rec is not None:
            self.manifest.pop("kernels", None)
        if os.path.isdir(self.blob_dir):
            for fn in os.listdir(self.blob_dir):
                rel = os.path.join("blobs", fn)
                if rel not in live_blobs and fn.endswith((".bin", ".so")):
                    try:
                        os.remove(os.path.join(self.blob_dir, fn))
                    except OSError:
                        pass
        return removed

    def stamp_baseline(self, fingerprint_set: str, path) -> None:
        self.manifest["baseline"] = {
            "fingerprint_set": fingerprint_set,
            "file": str(path),  # may arrive as a pathlib.Path
        }

    # -------------------------------------------------------------- verify

    def verify_against(
        self,
        baseline_data: Dict[str, Any],
        allow: Optional[Dict[str, Dict[str, str]]] = None,
        check_env: bool = True,
    ) -> List[Any]:
        """DP305 findings wherever the store disagrees with baselines.json:
        stale entries (fingerprint/interface drift or no longer baselined),
        missing entries, a corrupt kernel library, and a build-env/topology
        mismatch against the live process. Suppression goes through the
        same allowlist channel as the other DP3xx rules (`# noqa` has no
        source line to live on inside manifest.json)."""
        from dorpatch_tpu_torch.analysis import baseline as baseline_mod
        from dorpatch_tpu_torch.analysis.engine import Finding

        findings: List[Any] = []

        def add(name: str, msg: str) -> None:
            if baseline_mod.allowed(name, "DP305", allow):
                return
            findings.append(
                Finding(
                    path=self.manifest_path,
                    line=1,
                    col=0,
                    rule_id="DP305",
                    message=f"[{name}] {msg}",
                )
            )

        base_entries = baseline_data.get("entries", {})
        if check_env and self.entries():
            env = self.manifest.get("env") or {}
            live = current_env(self.device)
            bad = [k for k in _ENV_KEYS if env.get(k) != live.get(k)]
            if bad:
                add(
                    "<store>",
                    "store built under a different environment ("
                    + ", ".join(
                        f"{k}: {env.get(k)!r} != {live.get(k)!r}" for k in bad
                    )
                    + ") — its executables cannot serve here; rebuild with "
                    "`python -m dorpatch_tpu_torch.aot build`",
                )
        if self.kernels() is not None:
            rec = self.kernels()
            path = os.path.join(self.store_dir, rec.get("payload", ""))
            if _file_sha(path) != rec.get("payload_sha"):
                add(KERNELS, "kernel library blob unreadable (corrupt) — "
                    "rebuild")
        for name in sorted(self.entries()):
            entry = self.entries()[name]
            base = base_entries.get(name)
            if base is None:
                add(
                    name,
                    "store entry is no longer in baselines.json — stale; "
                    "run `python -m dorpatch_tpu_torch.aot gc`",
                )
                continue
            if base.get("fingerprint") != entry.get("fingerprint"):
                add(
                    name,
                    "store fingerprint "
                    f"{entry.get('fingerprint')} != baseline "
                    f"{base.get('fingerprint')} — stale executable; rebuild",
                )
            base_iface = (base.get("interface") or {}).get("sha")
            if (
                base_iface
                and entry.get("interface_sha")
                and base_iface != entry.get("interface_sha")
            ):
                add(
                    name,
                    "store interface hash disagrees with baseline "
                    "(DP304-style drift) — rebuild",
                )
            _, reason = self._read_payload(entry)
            if reason is not None:
                add(name, f"executable payload unreadable ({reason}) — rebuild")
        for name in sorted(base_entries):
            if name not in self.entries():
                add(
                    name,
                    "baselined program has no store entry — warm boot will "
                    "miss; run `python -m dorpatch_tpu_torch.aot build`",
                )
        return findings

    def select(self, globs) -> List[str]:
        names = sorted(self.entries())
        if not globs:
            return names
        return [
            n for n in names if any(fnmatch.fnmatch(n, g) for g in globs)
        ]


def open_readonly(store_dir: str, device=None) -> Optional[ExecutableStore]:
    """Best-effort open for boot paths that must never fail: returns None on
    any error (missing dir, unreadable manifest handled inside; this guards
    the truly unexpected)."""
    try:
        return ExecutableStore(store_dir, device=device)
    except Exception:
        return None


def find_manifest(store_dir: str) -> str:
    return os.path.join(os.path.abspath(store_dir), MANIFEST)


__all__ = [
    "ExecutableStore",
    "current_env",
    "topology_hash",
    "open_readonly",
    "find_manifest",
    "MANIFEST",
]
