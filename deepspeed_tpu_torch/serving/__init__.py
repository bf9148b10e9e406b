"""Serving resilience: the request-lifecycle layer above
:class:`~deepspeed_tpu_torch.inference.InferenceEngineV2` (counterpart of
``deepspeed_tpu/serving``). Host Python over the port's engine, whose
kernels run on the card.

* :mod:`~deepspeed_tpu_torch.serving.request` — request states, SLO tiers,
  the typed :class:`ShedError` backpressure signal (retryable overload vs
  terminal) and the per-request lifecycle record;
* :mod:`~deepspeed_tpu_torch.serving.manager` — :class:`RequestManager`:
  bounded admission queue, deadlines with KV/slot reclamation through
  ``engine.flush``, and the terminal ledger that makes "no request silently
  lost" checkable;
* :mod:`~deepspeed_tpu_torch.serving.batcher` — :class:`ContinuousBatcher`:
  the serving step loop (admission → chunked prefill → decode) with
  watermark shedding, SLO preemption (pause/resume through the KV tier
  store), STARTING/READY/DEGRADED/DRAINING health, SIGTERM drain and
  ``serving_report()``.

The network layer above the batcher:

* :mod:`~deepspeed_tpu_torch.serving.protocol` — the wire contract:
  generate request schema, tenant priority headers, ShedError →
  429/``Retry-After`` mapping, SSE framing;
* :mod:`~deepspeed_tpu_torch.serving.router` — :class:`Replica` (one
  batcher on its own worker thread) and :class:`ReplicaRouter`
  (least-loaded routing, sibling failover, drain with migration through
  durable manifests, rebalance of paused work);
* :mod:`~deepspeed_tpu_torch.serving.frontend` — :class:`ServingFrontend`:
  ``POST /v1/generate`` (unary JSON and SSE) on the same mux as
  ``/metrics`` / ``/healthz`` / ``/readyz``;
* :mod:`~deepspeed_tpu_torch.serving.client` — :class:`GenerateClient`:
  stdlib client honoring the 429/``Retry-After`` contract.

The elastic layer above the router (replica lifecycle):

* :mod:`~deepspeed_tpu_torch.serving.fleet` — :class:`FleetController`:
  crash detection, fail-over and respawn/readmit, autoscaling on queue
  depth, sheds and Retry-After with hysteresis, and rolling weight swaps
  that never drop below a min-READY floor;
* :mod:`~deepspeed_tpu_torch.serving.coldstart` — :class:`WarmStartCache`:
  AIO-streamed weight persistence and a reused model module, so a respawn
  is a warm start, keyed like the mesh winner store.

Drills: ``python -m deepspeed_tpu_torch.tools.serve_drill --list`` and
``python -m deepspeed_tpu_torch.tools.elastic_drill --list``.
"""

from deepspeed_tpu_torch.serving.batcher import (DEGRADED, DRAINING, READY,
                                                 STARTING, ContinuousBatcher)
from deepspeed_tpu_torch.serving.client import FrontendError, GenerateClient
from deepspeed_tpu_torch.serving.coldstart import WarmStartCache, warm_key
from deepspeed_tpu_torch.serving.fleet import FleetController
from deepspeed_tpu_torch.serving.frontend import ServingFrontend
from deepspeed_tpu_torch.serving.manager import RequestManager
from deepspeed_tpu_torch.serving.request import (CANCELLED, COMPLETED,
                                                 DECODING, EXPIRED, PREFILLING,
                                                 QUEUED, SHED, TERMINAL_STATES,
                                                 ServeRequest, ShedError)
from deepspeed_tpu_torch.serving.router import Replica, ReplicaRouter

__all__ = [
    "CANCELLED", "COMPLETED", "DECODING", "DEGRADED", "DRAINING", "EXPIRED",
    "PREFILLING", "QUEUED", "READY", "SHED", "STARTING", "TERMINAL_STATES",
    "ContinuousBatcher", "FleetController", "FrontendError", "GenerateClient",
    "Replica", "ReplicaRouter", "RequestManager", "ServeRequest",
    "ServingFrontend", "ShedError", "WarmStartCache", "warm_key",
]
