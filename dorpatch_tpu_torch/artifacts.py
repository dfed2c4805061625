"""Results-directory contract and artifact store (the resume/caching layer).

The same layout as `dorpatch_tpu.artifacts`, so both packages read each
other's results trees:

- the config-derived results path `results/<k=v ...>/<num_patch=.._patch_budget=..>`;
- per-batch patches `adv_mask_%d.pt` / `adv_pattern_%d.pt`, torch NCHW
  tensors; stage-0 patches under the same names in the parent directory,
  shared across patch budgets;
- recorded attack targets `targets_%d.pt`;
- pickled PatchCleanser records `adv_PC_%d.pt`.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from dorpatch_tpu_torch.config import ExperimentConfig, config_to_dict


def results_path(cfg: ExperimentConfig) -> str:
    """Config -> nested results directory."""
    keys = [
        ("dataset", cfg.dataset),
        ("base_arch", cfg.base_arch),
        ("targeted", cfg.attack.targeted),
        ("attack", cfg.attack_name),
        ("dropout", cfg.attack.dropout),
        ("density", cfg.attack.density),
        ("structured", cfg.attack.structured),
    ]
    if cfg.attack.dual:
        keys.append(("dual", True))
    if cfg.defense.n_patch != 1:
        keys.append(("defense_n_patch", cfg.defense.n_patch))
    top = "_".join(f"{k}={v}" for k, v in keys)
    sub = (f"num_patch={cfg.attack.num_patch}"
           f"_patch_budget={cfg.attack.patch_budget}")
    return os.path.join(cfg.results_root, top, sub)


def write_config_record(cfg: ExperimentConfig, result_dir: str) -> None:
    """Persist the experiment config beside the artifacts (`config.json`)."""
    try:
        with open(os.path.join(result_dir, "config.json"), "w") as fh:
            json.dump(config_to_dict(cfg), fh, indent=1, default=float)
    except OSError:
        pass  # read-only results dir: artifacts still work without it


def _to_nchw(arr) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return torch.from_numpy(np.array(np.moveaxis(np.asarray(arr), -1, 1),
                                     dtype=np.float32, copy=True))


def _from_nchw(t) -> np.ndarray:
    return np.moveaxis(np.asarray(t.detach().cpu(), dtype=np.float32), 1, -1)


class ArtifactStore:
    """Filesystem store rooted at the config's results directory; files
    hold NCHW tensors, the package works in NHWC."""

    def __init__(self, result_dir: str):
        self.result_dir = result_dir
        self.parent_dir = os.path.dirname(result_dir)
        os.makedirs(result_dir, exist_ok=True)

    def _patch_paths(self, batch_id: int, root: str) -> Tuple[str, str]:
        return (os.path.join(root, f"adv_mask_{batch_id}.pt"),
                os.path.join(root, f"adv_pattern_{batch_id}.pt"))

    def load_patch(self, batch_id: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        return self._load_pair(*self._patch_paths(batch_id, self.result_dir))

    def save_patch(self, batch_id: int, mask, pattern) -> None:
        self._save_pair(self._patch_paths(batch_id, self.result_dir), mask,
                        pattern)

    def load_stage0(self, batch_id: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        return self._load_pair(*self._patch_paths(batch_id, self.parent_dir))

    def save_stage0(self, batch_id: int, mask, pattern) -> None:
        os.makedirs(self.parent_dir, exist_ok=True)
        self._save_pair(self._patch_paths(batch_id, self.parent_dir), mask,
                        pattern)

    @staticmethod
    def _load_pair(mask_path, pattern_path):
        if not (os.path.exists(mask_path) and os.path.exists(pattern_path)):
            return None
        mask = torch.load(mask_path, map_location="cpu", weights_only=True)
        pattern = torch.load(pattern_path, map_location="cpu",
                             weights_only=True)
        return _from_nchw(mask), _from_nchw(pattern)

    @staticmethod
    def _save_pair(paths, mask, pattern) -> None:
        torch.save(_to_nchw(mask), paths[0])
        torch.save(_to_nchw(pattern), paths[1])

    # -- recorded attack targets --

    def _targets_path(self, batch_id: int) -> str:
        return os.path.join(self.result_dir, f"targets_{batch_id}.pt")

    def load_targets(self, batch_id: int) -> Optional[np.ndarray]:
        path = self._targets_path(batch_id)
        if not os.path.exists(path):
            return None
        return np.asarray(torch.load(path, map_location="cpu",
                                     weights_only=True))

    def save_targets(self, batch_id: int, targets) -> None:
        torch.save(torch.from_numpy(np.array(targets, copy=True)),
                   self._targets_path(batch_id))

    def resolve_targets(self, batch_id: int, rederive) -> np.ndarray:
        """Targets for a cached patch: the recorded file, else
        `rederive((mask, pattern))` from the shared stage-0 artifacts."""
        t = self.load_targets(batch_id)
        if t is not None:
            return np.asarray(t)
        s0 = self.load_stage0(batch_id)
        if s0 is None:
            raise FileNotFoundError(
                f"targeted resume for batch {batch_id} needs the recorded "
                f"targets or the shared stage-0 artifacts in "
                f"{self.parent_dir}; delete the per-budget patch files too "
                "to regenerate")
        return np.asarray(rederive(s0))

    # -- PatchCleanser record cache --

    def _pc_path(self, batch_id: int) -> str:
        return os.path.join(self.result_dir, f"adv_PC_{batch_id}.pt")

    def load_pc_records(self, batch_id: int):
        path = self._pc_path(batch_id)
        if not os.path.exists(path):
            return None
        with open(path, "rb") as f:
            return pickle.load(f)

    def save_pc_records(self, batch_id: int, records: Sequence) -> None:
        with open(self._pc_path(batch_id), "wb") as f:
            pickle.dump(records, f)
