"""Analysis-as-a-service: a long-lived multi-tenant daemon.

Every pre-service entry point is a cold one-shot process: each request
re-pays its kernel builds, SMT query-cache warmup, and runs its contract
alone on the device even when the slot batch is mostly empty.  This
package converts the batch tool into a server:

* ``daemon.AnalysisService`` — the admission plane + its workers.  With
  ``workers=1`` (default) one worker thread owns the (non-reentrant)
  analysis singletons and runs admitted requests as shared wide device
  batches via the cooperative corpus sweep
  (``analysis/cooperative.run_cooperative_batch``), streaming issues back
  per request as they confirm.  With ``workers=N`` a horizontal pool of
  N worker *processes* (``pool``/``worker``) runs N batches concurrently
  behind the same admission queue, sharing the on-disk caches and the
  cross-process completed-result LRU (``resultstore``) under one
  ``--cache-root``.
* ``admission.AdmissionController`` — queue + dedup + scheduling.
  Submissions are keyed by canonical codehash + options; duplicate
  submitters subscribe to the in-flight result (replay-then-live
  ordering) or get a cached replay of a completed one.  An optional
  ``scheduling.SchedulerPolicy`` adds tenant quotas, batch-tier load
  shedding, and priority aging.
* ``server.run_server`` / ``client.ServiceClient`` — a thin JSON-lines
  TCP layer (``myth serve`` / ``myth submit``) over the in-process API.
* ``telemetry.RequestTelemetry`` — the request-scoped telemetry plane:
  per-phase latency decomposition (queue-wait/batch-wait/execute/stream
  histograms + percentiles in ``stats()``), per-tenant accounting,
  per-request trace span trees flow-joined to the frontier's segment
  spans, and the ``--request-log`` JSONL.  ``top.run_top`` renders a
  live operator view (``myth top``) from polled stats.

Determinism contract: each request's issue set (by
``codehash.issue_digest``) is bit-identical to a solo run of the same
contract — shared batching changes scheduling, never findings.  See
docs/source/service.rst.
"""

from mythril_tpu_torch.service.codehash import (  # noqa: F401
    canonical_codehash,
    issue_digest,
    normalize_code,
    options_key,
)
from mythril_tpu_torch.service.request import (  # noqa: F401
    AnalysisOptions,
    AnalysisRequest,
    ResultStream,
    issue_to_wire,
)
from mythril_tpu_torch.service.admission import AdmissionController  # noqa: F401
from mythril_tpu_torch.service.scheduling import (  # noqa: F401
    AdmissionRejected,
    SchedulerPolicy,
)
from mythril_tpu_torch.service.telemetry import RequestTelemetry  # noqa: F401
from mythril_tpu_torch.service.daemon import (  # noqa: F401
    AnalysisService,
    ServiceConfig,
)
