"""Online certified-inference service of the port: micro-batched
PatchCleanser serving over warmed shape buckets, bounded-queue
backpressure, a supervised replica pool (one thread, defense bank and CUDA
stream per replica), an `http.server` JSON front-end, and the JAX
package's telemetry records. Port of `dorpatch_tpu.serve`.

    service = CertifiedInferenceService.from_config(cfg)
    with service, HttpFrontend(service, port=cfg.serve.port):
        ...                      # or: python -m dorpatch_tpu_torch.serve

    service.predict(image)       # direct Python client (no sockets)

See `service.py` for the request lifecycle, `batcher.py` for the
size-or-deadline flush rules, `types.py` for the typed responses, and
`pool.py` for the supervised replica pool.
"""

from dorpatch_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatcher,
    PendingRequest,
)
from dorpatch_tpu_torch.serve.http import HttpFrontend  # noqa: F401
from dorpatch_tpu_torch.serve.pool import Replica, ReplicaPool  # noqa: F401
from dorpatch_tpu_torch.serve.service import (  # noqa: F401
    CertifiedInferenceService,
    marshal_response,
    resolved_bucket_sizes,
)
from dorpatch_tpu_torch.serve.types import (  # noqa: F401
    HTTP_STATUS,
    DeadlineExceeded,
    Overloaded,
    PredictResult,
    RadiusVerdict,
    ServeError,
)

__all__ = [
    "HTTP_STATUS",
    "CertifiedInferenceService",
    "DeadlineExceeded",
    "HttpFrontend",
    "MicroBatcher",
    "Overloaded",
    "PendingRequest",
    "PredictResult",
    "RadiusVerdict",
    "Replica",
    "ReplicaPool",
    "ServeError",
    "marshal_response",
    "resolved_bucket_sizes",
]
