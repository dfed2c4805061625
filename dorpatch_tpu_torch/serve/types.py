"""Typed request/response messages of the certified-inference service.

Port of `dorpatch_tpu.serve.types`: `to_dict` gives the JAX package's bytes.

Every answer the service gives is one of these frozen dataclasses — the
Python client returns them directly, the HTTP front-end maps them onto
status codes + JSON via `to_dict`. A rejected request is DATA
(`Overloaded`), not an exception: backpressure is part of the serving
contract (bounded queue, typed reject) rather than an error path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class RadiusVerdict:
    """One PatchCleanser certifier's answer (one mask family / patch ratio)."""

    ratio: float
    prediction: int
    certified: bool


@dataclasses.dataclass(frozen=True)
class PredictResult:
    """Successful certified prediction for one image.

    `prediction`/`certified` are the headline answer: the smallest-radius
    defense's double-masking prediction, certified iff EVERY radius in the
    bank certifies (the conservative join the pipeline's certified-accuracy
    metric uses). `verdicts` carries the full per-radius breakdown,
    `clean_prediction` the undefended model argmax."""

    status = "ok"
    prediction: int
    certified: bool
    clean_prediction: int
    verdicts: Tuple[RadiusVerdict, ...]
    latency_ms: float
    bucket: int          # padded batch size the request rode in
    batch_images: int    # real (unpadded) images in that batch
    certify_forwards: Optional[int] = None
    # ^ masked-table entries this image's certification evaluated across
    #   the whole defense bank (the pruned scheduler's per-image cost; None
    #   only for responses predating forward accounting)
    certify_forward_equivalents: Optional[float] = None
    # ^ the same cost in fractional full-forward units: incremental
    #   entries (token-pruned ViT / stem-folded conv) credited at their
    #   true fraction of a forward — == certify_forwards when the
    #   incremental path is off

    def to_dict(self) -> dict:
        out = {
            "status": self.status,
            "prediction": self.prediction,
            "certified": self.certified,
            "clean_prediction": self.clean_prediction,
            "verdicts": [dataclasses.asdict(v) for v in self.verdicts],
            "latency_ms": round(self.latency_ms, 3),
            "bucket": self.bucket,
            "batch_images": self.batch_images,
        }
        if self.certify_forwards is not None:
            out["certify_forwards"] = self.certify_forwards
        if self.certify_forward_equivalents is not None:
            out["certify_forward_equivalents"] = round(
                self.certify_forward_equivalents, 2)
        return out


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed backpressure reject: the bounded queue is full. Clients should
    back off and retry; nothing was enqueued."""

    status = "overloaded"
    queue_depth: int
    limit: int

    def to_dict(self) -> dict:
        return {"status": self.status, "queue_depth": self.queue_depth,
                "limit": self.limit}


@dataclasses.dataclass(frozen=True)
class DeadlineExceeded:
    """The request's latency budget elapsed before its batch finished; the
    (stale) result is withheld so callers never act on an expired answer."""

    status = "deadline_exceeded"
    latency_ms: float
    deadline_ms: float

    def to_dict(self) -> dict:
        return {"status": self.status,
                "latency_ms": round(self.latency_ms, 3),
                "deadline_ms": round(self.deadline_ms, 3)}


@dataclasses.dataclass(frozen=True)
class ServeError:
    """Malformed input (`status="error"` -> 400) or a server-side failure
    (`status="internal_error"` -> 500, so clients and load balancers retry
    and alert on the right side of the contract)."""

    reason: str
    latency_ms: Optional[float] = None
    status: str = "error"

    def to_dict(self) -> dict:
        out = {"status": self.status, "reason": self.reason}
        if self.latency_ms is not None:
            out["latency_ms"] = round(self.latency_ms, 3)
        return out


#: HTTP status code per response type (the front-end's mapping).
HTTP_STATUS = {
    "ok": 200,
    "overloaded": 503,
    "deadline_exceeded": 504,
    "error": 400,
    "internal_error": 500,
}
