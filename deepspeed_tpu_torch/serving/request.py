"""Request lifecycle primitives for the serving layer (counterpart of
``deepspeed_tpu/serving/request.py``).

A request moves through a small, explicit state machine; every terminal
state is recorded so the serving invariant — *no admitted request is ever
silently lost* — is checkable from the outside (``deepspeed_tpu_torch/tools/serve_drill.py``
asserts it after every drill):

    QUEUED ──admit──▶ PREFILLING ──▶ DECODING ──▶ COMPLETED
       │                  │         ▲      │
       │                  └─▶ PAUSED ◀─────┤
       │                  │              │
       └──────── shed / expire / cancel ─┴──▶ SHED | EXPIRED | CANCELLED

PAUSED is the preemption state: the request's KV blocks have been demoted
through the tier store and its HBM freed, but it is still live, still
resolvable, and resumes (promote + continue decoding, bit-identical greedy
tokens) when capacity returns. A paused request stays in the manager's
``active`` ledger so it is never "lost" to the router's liveness probes.

Every request carries an SLO **tier** — ``latency`` (chat), ``throughput``
(agents), ``batch`` (offline / spot) — that drives admission budgets,
victim selection (batch pays for latency bursts), and tier-labeled SLO
metrics. Tier is orthogonal to ``priority``: priority orders sheds *within*
a tier; tier decides who gets paused first.

``ShedError`` is the typed backpressure signal: it says *the system chose to
drop this request because of load*, distinguishes retryable overload (queue
full, KV pressure, draining) from terminal causes, and carries a
``retry_after_s`` hint so clients can back off instead of hammering an
overloaded server.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

__all__ = ["QUEUED", "PREFILLING", "DECODING", "PAUSED", "COMPLETED", "SHED",
           "EXPIRED", "CANCELLED", "TERMINAL_STATES", "TIER_LATENCY",
           "TIER_THROUGHPUT", "TIER_BATCH", "TIERS", "ShedError",
           "ServeRequest"]

QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"
PAUSED = "paused"
COMPLETED = "completed"
SHED = "shed"
EXPIRED = "expired"
CANCELLED = "cancelled"

TERMINAL_STATES = (COMPLETED, SHED, EXPIRED, CANCELLED)

# SLO tiers, ordered most- to least-latency-sensitive. Victim selection
# walks this order BACKWARDS (batch pays first); admission budgets and the
# fleet's autoscaling signals key off the same strings.
TIER_LATENCY = "latency"
TIER_THROUGHPUT = "throughput"
TIER_BATCH = "batch"
TIERS = (TIER_LATENCY, TIER_THROUGHPUT, TIER_BATCH)


class ShedError(RuntimeError):
    """The serving layer dropped (or refused) a request because of load.

    ``reason`` is a stable machine-readable slug (``queue_full``,
    ``kv_pressure``, ``queue_pressure``, ``shed_storm``, ``draining``,
    ``drain_timeout``, ``decode_failure``, ``capacity``, ``oversize``);
    ``retryable`` tells the client whether resubmitting later can succeed
    (overload sheds — including ``capacity`` — are retryable; ``oversize``,
    a request that can never fit, is not)."""

    def __init__(self, reason: str, uid: Optional[int] = None,
                 retryable: bool = True,
                 retry_after_s: Optional[float] = None, detail: str = ""):
        self.reason = reason
        self.uid = uid
        self.retryable = bool(retryable)
        self.retry_after_s = retry_after_s
        msg = f"request shed ({reason})"
        if uid is not None:
            msg += f" uid={uid}"
        if retryable:
            msg += (f"; retry after {retry_after_s:.1f}s"
                    if retry_after_s else "; retryable")
        if detail:
            msg += f": {detail}"
        super().__init__(msg)


@dataclasses.dataclass
class ServeRequest:
    """One in-flight generation request and its full lifecycle record."""

    uid: int
    prompt: np.ndarray                 # int32 [prompt_len]
    max_new_tokens: int
    priority: int = 0                  # higher = shed later
    tier: str = TIER_THROUGHPUT        # SLO tier: latency|throughput|batch
    deadline: Optional[float] = None   # absolute clock() time, None = none
    submitted_at: float = 0.0
    state: str = QUEUED
    # progress
    prefilled: int = 0                 # prompt tokens already in KV
    generated: List[int] = dataclasses.field(default_factory=list)
    next_token: Optional[int] = None   # token to feed on the next decode step
    # span timestamps (batcher clock domain) — the request IS its trace
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    last_token_at: Optional[float] = None
    # causal event-bus track id (observability.tracing); None = tracing
    # off or this request sampled out — emit nothing for it
    trace_id: Optional[int] = None
    # preemption bookkeeping (see PAUSED above): the starvation guard
    # refuses to pause a request again before its progress (prefilled +
    # generated tokens) has advanced past where the last pause left it
    pause_count: int = 0
    progress_at_last_pause: int = -1
    paused_at: Optional[float] = None
    # cross-replica migration bookkeeping: ``migrated_from`` names the
    # donor replica for a request adopted here (crash or rebalance);
    # ``replay`` holds the engine-side re-prefill token stream when the
    # durable KV was unavailable — already-emitted tokens are recomputed
    # into KV, never re-emitted (see :meth:`prepare_replay`)
    migrated_from: Optional[str] = None
    replay: Optional[np.ndarray] = None
    # terminal bookkeeping
    finish_reason: str = ""            # length | eos | shed slug | expired
    error: Optional[ShedError] = None
    finished_at: Optional[float] = None

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def total_token_demand(self) -> int:
        """Worst-case KV footprint in tokens (admission uses this so a
        request admitted under pressure cannot strand mid-generation)."""
        return self.prompt_len + self.max_new_tokens

    @property
    def done(self) -> bool:
        return self.state in TERMINAL_STATES

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline

    @property
    def progress(self) -> int:
        """Tokens of work materialised in KV so far (prefilled prompt +
        generated) — the starvation guard's monotonic progress measure."""
        return self.prefilled + len(self.generated)

    @property
    def remaining_tokens(self) -> int:
        """Worst-case tokens still to produce — victim selection prefers
        the request with the MOST remaining work (its pause wastes the
        least already-spent compute per freed block)."""
        return max(0, self.max_new_tokens - len(self.generated))

    def shed_key(self) -> tuple:
        """Sort key for victim selection: lowest priority first, then newest
        (LIFO within a priority class — the request that waited longest keeps
        its place)."""
        return (self.priority, -self.submitted_at)

    def preempt_key(self) -> tuple:
        """Sort key for PAUSE victim selection (ascending = pause first):
        batch tier before throughput before latency, deadline-free requests
        before deadlined ones (a pause must not convert into an expiry),
        most-remaining-work first, then the plain shed order."""
        try:
            tier_rank = TIERS.index(self.tier)
        except ValueError:
            tier_rank = len(TIERS)
        return (-tier_rank, self.deadline is not None,
                -self.remaining_tokens, self.shed_key())

    @property
    def feed_source(self) -> np.ndarray:
        """The token stream the prefill plan feeds: the replay stream (a
        re-prefill recomputing lost KV) when armed, else the prompt."""
        return self.replay if self.replay is not None else self.prompt

    @property
    def feed_len(self) -> int:
        """Prefill target length for the current feed source."""
        return int(len(self.replay)) if self.replay is not None \
            else self.prompt_len

    def prepare_replay(self) -> None:
        """Arm the re-prefill fallback: the KV is gone (crash without a
        durable manifest, or a migrate/resume tier read failed) but the
        token history is not. The replay stream — prompt plus all but the
        last generated token — is recomputed into KV, then decoding
        continues from the last generated token; the replay's final
        logits predict that already-known token and are DISCARDED.
        Client-facing ``prompt``/``generated`` are untouched (nothing is
        re-emitted). With nothing generated yet this is a plain prefill
        restart."""
        self.prefilled = 0
        if self.generated:
            self.replay = np.concatenate(
                [self.prompt,
                 np.asarray(self.generated[:-1], np.int32)]).astype(np.int32)
            self.next_token = int(self.generated[-1])
        else:
            self.replay = None
            self.next_token = None

    def pause_allowed(self) -> bool:
        """Starvation guard: a request may be paused again only after it
        advanced past the progress point of its previous pause."""
        return self.pause_count == 0 \
            or self.progress > self.progress_at_last_pause

    def span(self) -> dict:
        """The request's trace: admit → queue-wait → TTFT → per-token decode
        → terminal, in milliseconds of the batcher's clock domain. Fields
        are None until the request reaches that point of its lifecycle."""
        def ms(a, b):
            return None if a is None or b is None else round((b - a) * 1e3, 3)
        n_decode_gaps = max(0, len(self.generated) - 1)
        decode_ms = ms(self.first_token_at, self.last_token_at)
        return {
            "uid": self.uid, "state": self.state,
            "trace_id": self.trace_id, "tier": self.tier,
            "pauses": self.pause_count,
            "finish_reason": self.finish_reason or None,
            "prompt_tokens": self.prompt_len,
            "generated_tokens": len(self.generated),
            "queue_wait_ms": ms(self.submitted_at, self.admitted_at),
            "ttft_ms": ms(self.submitted_at, self.first_token_at),
            "tpot_ms": (None if not n_decode_gaps or decode_ms is None
                        else round(decode_ms / n_decode_gaps, 3)),
            "e2e_ms": ms(self.submitted_at, self.finished_at),
        }


def as_prompt(tokens: Sequence[int]) -> np.ndarray:
    arr = np.atleast_1d(np.asarray(tokens, np.int32))
    if arr.ndim != 1 or arr.size == 0:
        raise ValueError(f"prompt must be a non-empty 1-D token sequence, "
                         f"got shape {arr.shape}")
    return arr
