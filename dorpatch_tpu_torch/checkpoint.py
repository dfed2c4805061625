"""Mid-stage snapshots of the attack carry (crash recovery), and the
crash-safe JSON primitives of the farm.

Port of `dorpatch_tpu.checkpoint`. The attack's whole adaptive state (the
`attack.TrainState`: iterates, best-so-far copies, failure set, adaptive
coefficients, lr/patience schedules and the mask sampler's generator) is
snapshotted at sweep-block boundaries, with the stage, the iteration and
the stage-0 artifacts stage 1 depends on. A killed run restores the newest
snapshot and continues from that block, bit for bit.

Orbax is replaced by one `torch.save` of the carry's tensors moved to the
CPU, with the generator as its `get_state()` bytes (a `torch.Generator`
does not pickle). A snapshot is a directory `<dir>/<step>/` holding
`meta.json` and `carry.pt`, step = stage * 10_000_000 + iteration as in the
JAX package; it is written into a temporary directory, fsynced and committed
with one `os.replace`, so a crash mid-save leaves either no step directory
or a complete one. A step directory without a readable `meta.json` (a torn
write, or the JAX package's orbax layout) counts as corrupt: it is deleted
and the previous snapshot is restored.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import warnings
from typing import Any, List, NamedTuple, Optional

META_NAME = "meta.json"
CARRY_NAME = "carry.pt"
_TMP_PREFIX = ".tmp-"


def atomic_write_json(path: str, obj: Any) -> None:
    """Crash-safe JSON write: same-directory `*.tmp.<pid>.<thread>` +
    `os.replace`.

    A reader never observes a half-written file: a crash mid-write leaves
    either the previous content or the new one (plus at worst a stray tmp
    file). The tmp name carries the pid and the thread so concurrent
    writers on the same path, in processes or in threads of one, never
    clobber each other's in-flight tmp; the `os.replace` is the single
    atomic commit point. The persistence primitive of every mutable
    JSON record that must survive SIGKILL (`farm/queue.py`'s job and lease
    state)."""
    path = os.path.abspath(path)
    tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
    with open(tmp, "w") as fh:
        json.dump(obj, fh, indent=1, sort_keys=True, default=float)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def load_json(path: str, default: Any = None) -> Any:
    """Read a JSON file, returning `default` when it is missing, unreadable,
    or truncated/corrupt: crash-recovery readers classify bad state, they
    never die on it."""
    try:
        with open(path) as fh:
            return json.load(fh)
    except (OSError, ValueError):
        return default


class CarryCheckpoint(NamedTuple):
    """A restored mid-stage snapshot."""

    stage: int
    iteration: int
    state: Any                      # attack.TrainState
    stage0_mask: Any                # None while still in stage 0
    stage0_pattern: Any


def _fsync_tree(directory: str) -> None:
    for name in os.listdir(directory):
        fd = os.open(os.path.join(directory, name), os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    fd = os.open(directory, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class CarryCheckpointer:
    """Snapshots of the attack carry in one directory.

    One instance per attack invocation (e.g. per experiment batch or sweep
    point). `save` keeps the newest `max_to_keep` snapshots; `restore`
    returns the newest restorable one or None. `clear` removes all
    snapshots (call it after a successful generate, so a stale carry never
    leaks into the next run).

    `fingerprint` (any JSON-serializable dict: seed, batch id, attack
    config, ...) is stored in the snapshot meta. On construction,
    snapshots whose stored fingerprint differs from this instance's are
    deleted with a warning: a stale run's carry must never be restored by
    this run (the JAX package purges them for the same reason, and because
    orbax refuses saves below the newest step). A re-run with e.g. another
    seed therefore regenerates instead of restoring a carry trained on
    other images or targets.
    """

    def __init__(self, directory: str, max_to_keep: int = 2,
                 fingerprint: Optional[dict] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = int(max_to_keep)
        self.fingerprint = fingerprint
        os.makedirs(self.directory, exist_ok=True)
        for name in os.listdir(self.directory):
            if name.startswith(_TMP_PREFIX):  # a save cut by a crash
                shutil.rmtree(os.path.join(self.directory, name),
                              ignore_errors=True)
        if fingerprint is not None:
            for step in self.all_steps():
                meta = self._read_meta(step)
                if meta is None or meta.get("fingerprint") != fingerprint:
                    got = None if meta is None else meta.get("fingerprint")
                    warnings.warn(
                        f"carry snapshot {step} in {self.directory} has "
                        f"fingerprint {got!r} != this run's "
                        f"{fingerprint!r}; deleting it (it could shadow "
                        "restores)")
                    self._delete_quietly(step)

    # ---------------- layout ----------------

    def all_steps(self) -> List[int]:
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names if n.isdigit()
                      and os.path.isdir(os.path.join(self.directory, n)))

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _read_meta(self, step: int) -> Optional[dict]:
        """The snapshot's meta record, or None when it is missing,
        truncated or corrupt (a crash mid-write must not kill the
        reader)."""
        meta = load_json(os.path.join(self._step_dir(step), META_NAME))
        if not isinstance(meta, dict) or "stage" not in meta \
                or "iteration" not in meta:
            return None
        return meta

    def _delete_quietly(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step), ignore_errors=True)

    # ---------------- save / restore ----------------

    def save(self, stage: int, iteration: int, state: Any,
             stage0_mask=None, stage0_pattern=None) -> None:
        """Snapshot the carry at a block boundary: the tensors of `state`
        (moved to the CPU), its generator's state, and the stage-0
        artifacts in stage 1. Atomic at the snapshot granularity."""
        import torch

        step = int(stage) * 10_000_000 + int(iteration)
        tensors, gen_state = {}, None
        for f in dataclasses.fields(state):
            v = getattr(state, f.name)
            if isinstance(v, torch.Generator):
                gen_state = v.get_state()
            else:
                tensors[f.name] = v.detach().to("cpu", copy=True)
        payload = {"state": tensors, "gen": gen_state}
        if stage0_mask is not None:
            payload["stage0"] = {"mask": stage0_mask.detach().cpu(),
                                 "pattern": stage0_pattern.detach().cpu()}
        meta = {"stage": int(stage), "iteration": int(iteration)}
        if self.fingerprint is not None:
            meta["fingerprint"] = self.fingerprint
        tmp = os.path.join(self.directory,
                           f"{_TMP_PREFIX}{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        try:
            torch.save(payload, os.path.join(tmp, CARRY_NAME))
            with open(os.path.join(tmp, META_NAME), "w") as fh:
                json.dump(meta, fh, sort_keys=True)
            _fsync_tree(tmp)
            final = self._step_dir(step)
            if os.path.exists(final):
                self._delete_quietly(step)
            os.replace(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        for old in self.all_steps()[:-self.max_to_keep]:
            self._delete_quietly(old)

    def _load(self, step: int, meta: dict, state_template,
              stage0_template):
        """The snapshot's carry as a TrainState placed like the template;
        raises on anything unreadable or of another shape or dtype."""
        import torch

        payload = torch.load(os.path.join(self._step_dir(step), CARRY_NAME),
                             map_location="cpu", weights_only=True)
        saved = payload["state"]
        fields = {}
        for f in dataclasses.fields(state_template):
            like = getattr(state_template, f.name)
            if isinstance(like, torch.Generator):
                gen = torch.Generator(device=like.device)
                gen.set_state(payload["gen"])
                fields[f.name] = gen
                continue
            v = saved[f.name]
            if v.shape != like.shape or v.dtype != like.dtype:
                raise ValueError(
                    f"field {f.name}: snapshot {tuple(v.shape)} {v.dtype}, "
                    f"this run {tuple(like.shape)} {like.dtype}")
            fields[f.name] = v.to(like.device)
        state = type(state_template)(**fields)
        s0 = payload.get("stage0")
        if meta["stage"] == 1:
            if stage0_template is None:
                raise ValueError("stage-1 checkpoint needs a stage-0 template")
            if s0 is None:
                raise ValueError("stage-1 snapshot without stage-0 artifacts")
            mask = s0["mask"].to(stage0_template[0].device)
            pattern = s0["pattern"].to(stage0_template[1].device)
            if (mask.shape != stage0_template[0].shape
                    or pattern.shape != stage0_template[1].shape):
                raise ValueError("stage-0 artifacts of another shape")
            return state, mask, pattern
        return state, None, None

    def restore(self, state_template: Any, stage0_template=None
                ) -> Optional[CarryCheckpoint]:
        """Newest readable snapshot whose fingerprint matches this run's,
        tensors placed like the (concrete) templates.

        Two classes of snapshot are passed over, falling back to the next
        older one instead of crashing mid-resume:

        - fingerprint mismatch (skipped with a warning);
        - truncated/corrupt meta or payload (a crash or ENOSPC mid-save, or
          another package's snapshot format): deleted with a warning, and
          the previous good one is restored instead."""
        for step in sorted(self.all_steps(), reverse=True):
            meta = self._read_meta(step)
            if meta is None:
                warnings.warn(
                    f"carry snapshot {step} in {self.directory} is "
                    "truncated/corrupt (unreadable meta); deleting it and "
                    "falling back to the previous snapshot")
                self._delete_quietly(step)
                continue
            if (self.fingerprint is not None
                    and meta.get("fingerprint") != self.fingerprint):
                warnings.warn(
                    f"carry snapshot {step} in {self.directory} has "
                    f"fingerprint {meta.get('fingerprint')!r} != this run's "
                    f"{self.fingerprint!r}; skipping it")
                continue
            try:
                state, mask, pattern = self._load(step, meta, state_template,
                                                  stage0_template)
            except Exception as e:
                warnings.warn(
                    f"carry snapshot {step} in {self.directory} failed to "
                    f"restore ({type(e).__name__}: {e}); deleting it and "
                    "falling back to the previous snapshot")
                self._delete_quietly(step)
                continue
            return CarryCheckpoint(stage=int(meta["stage"]),
                                   iteration=int(meta["iteration"]),
                                   state=state, stage0_mask=mask,
                                   stage0_pattern=pattern)
        return None

    def latest_step_info(self) -> Optional[CarryCheckpoint]:
        """Meta of the newest matching snapshot as a `CarryCheckpoint` with
        `state` and the artifacts None: a host-only peek (nothing loaded)
        for resume accounting. None when nothing restorable exists."""
        for step in sorted(self.all_steps(), reverse=True):
            meta = self._read_meta(step)
            if meta is None:
                continue
            if (self.fingerprint is not None
                    and meta.get("fingerprint") != self.fingerprint):
                continue
            return CarryCheckpoint(
                stage=int(meta["stage"]), iteration=int(meta["iteration"]),
                state=None, stage0_mask=None, stage0_pattern=None)
        return None

    def clear(self) -> None:
        for step in self.all_steps():
            self._delete_quietly(step)

    def close(self) -> None:
        """Saves are synchronous: nothing to flush."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
