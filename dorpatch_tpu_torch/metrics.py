"""Final-report metrics: clean/robust accuracy plus per-radius acc@PC,
certified-acc@PC and certified-ASR@PC, as data and as the report line."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _fmt_list(values: Sequence[float]) -> str:
    return ", ".join(f"{v:.2f}" for v in values)


def compute_metrics(preds_clean: np.ndarray, y: np.ndarray,
                    preds_adv: np.ndarray, defense_results: Sequence,
                    targets: Optional[np.ndarray] = None) -> Dict:
    """All final metrics. `targets` given -> targeted certified-ASR
    (prediction == target & certified); else untargeted (!= label &
    certified)."""
    acc_pc: List[float] = []
    cert_acc_pc: List[float] = []
    cert_asr_pc: List[float] = []
    for res in defense_results:
        p, c = res.predictions, res.certifications
        acc_pc.append(float((p == y).mean() * 100))
        cert_acc_pc.append(float(((p == y) & c).mean() * 100))
        if targets is not None:
            cert_asr_pc.append(float(((p == targets) & c).mean() * 100))
        else:
            cert_asr_pc.append(float(((p != y) & c).mean() * 100))
    return {
        "clean_accuracy": float((preds_clean == y).mean() * 100),
        "robust_accuracy": float((preds_adv == y).mean() * 100),
        "acc_pc": acc_pc,
        "certified_acc_pc": cert_acc_pc,
        "certified_asr_pc": cert_asr_pc,
    }


def report_line(m: Dict) -> str:
    """The single printed report line."""
    return (
        "clean accuracy: {:.2f}%, robust accuracy:{:.2f}%, acc@PC:{:s}%, "
        "certified_ACC@PC:{:s}%, certified_ASR@PC:{:s}%".format(
            m["clean_accuracy"], m["robust_accuracy"], _fmt_list(m["acc_pc"]),
            _fmt_list(m["certified_acc_pc"]),
            _fmt_list(m["certified_asr_pc"])))
