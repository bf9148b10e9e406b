"""AutoEP-style expert load balancing (counterpart of
``deepspeed_tpu/moe/balancer.py``): observe per-expert token counts, plan
a replication / re-placement of the expert stacks, and rewrite the weight
dict into physical slot order with placement tables.

- :class:`ExpertLoadTracker` -- host-side accumulator fed by the dispatch
  (``sharded_moe.set_expert_tracker``; one report per dispatched block), and
  the bridge into the metrics registry (``moe/expert_tokens{expert=}``
  counters, ``moe/imbalance`` gauge = max/mean of the window totals).
- :func:`plan_rebalance` -- greedy replication (each spare slot goes to
  the expert with the highest per-replica load) followed by LPT placement
  (heaviest replica units first, onto the least-loaded shard with a free
  slot), with the classical bound
  ``max_shard_load / mean_shard_load <= 1 + max_unit / mean_shard_load``.
- :func:`placement_tables` / :func:`apply_placement` -- turn a plan's slot
  assignment into the ``place_dest`` / ``place_slot`` / ``place_nrep``
  tables and gather the expert stacks into physical slot order.

The tables are read by the expert-parallel dispatch, which waits for a mesh
(ROADMAP section 1, "Mesh, ZeRO and tensor parallelism"); on one device
they are built and tested. Planning is numpy, as in the reference.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "ExpertLoadTracker",
    "RebalancePlan",
    "apply_placement",
    "placement_tables",
    "plan_rebalance",
    "shard_loads",
]


class ExpertLoadTracker:
    """Host-side per-expert token counter with a metrics-registry bridge.

    ``observe(counts)`` is called on every dispatched MoE block with its
    routed-pair counts (length ``num_experts``; under expert parallelism
    one report per shard, and the reports add up). The registry counters
    are cumulative (Prometheus semantics); the window totals behind
    :meth:`snapshot`/:meth:`imbalance` reset with :meth:`reset` so a
    rebalance plans against fresh traffic.
    """

    def __init__(self, num_experts: int, registry: Any = None):
        self.num_experts = int(num_experts)
        self._lock = threading.Lock()
        self._window = np.zeros(self.num_experts, dtype=np.int64)
        self._counters = None
        self._gauge = None
        if registry is not None:
            self._counters = [
                registry.counter(
                    "moe/expert_tokens",
                    help="routed (token, expert) pairs per expert",
                    labels={"expert": str(e)})
                for e in range(self.num_experts)
            ]
            self._gauge = registry.gauge(
                "moe/imbalance",
                help="max/mean per-expert token load over the current "
                     "rebalance window (1.0 = perfectly balanced)")

    def observe(self, counts) -> None:
        c = np.asarray(counts, dtype=np.int64).reshape(-1)
        if c.shape[0] != self.num_experts:
            raise ValueError(f"expected {self.num_experts} counts, "
                             f"got {c.shape[0]}")
        with self._lock:
            self._window += c
            if self._counters is not None:
                for inst, v in zip(self._counters, c):
                    if v:
                        inst.inc(float(v))
            if self._gauge is not None:
                self._gauge.set(_imbalance(self._window))

    def snapshot(self) -> np.ndarray:
        with self._lock:
            return self._window.copy()

    def imbalance(self) -> float:
        with self._lock:
            return _imbalance(self._window)

    def reset(self) -> None:
        with self._lock:
            self._window[:] = 0


def _imbalance(loads: np.ndarray) -> float:
    total = float(loads.sum())
    if total <= 0:
        return 1.0
    return float(loads.max()) / (total / len(loads))


def shard_loads(assign: Sequence[int], counts, ep: int) -> np.ndarray:
    """Expected per-shard token load under ``assign`` (slot -> expert),
    with each expert's count split evenly across its replicas -- exactly
    how ``_grouped_moe_ep`` spreads pairs (round-robin over replicas)."""
    assign = np.asarray(assign, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.float64)
    slots = len(assign) // ep
    nrep = np.bincount(assign, minlength=len(counts))
    per_rep = counts / np.maximum(nrep, 1)
    return per_rep[assign].reshape(ep, slots).sum(axis=1)


@dataclasses.dataclass(frozen=True)
class RebalancePlan:
    """A slot assignment plus the before/after accounting the drills and
    the ``rebalance_moe`` gate read."""

    assign: List[int]              #: physical slot -> expert id (ep*slots)
    nrep: List[int]                #: replicas per expert
    imbalance_before: float        #: shard max/mean under prev assignment
    imbalance_after: float         #: shard max/mean under this plan
    max_unit_frac: float           #: max replica unit / mean shard load
    moved_slots: int               #: slots whose expert changed vs prev

    @property
    def bound(self) -> float:
        """The documented LPT bound on ``imbalance_after``."""
        return 1.0 + self.max_unit_frac


def plan_rebalance(counts, ep: int, slots_per_shard: int,
                   prev_assign: Optional[Sequence[int]] = None
                   ) -> RebalancePlan:
    """Greedy replicate + LPT place. ``counts`` is the per-expert token
    window (``ExpertLoadTracker.snapshot``); the grid has ``ep`` shards
    of ``slots_per_shard`` physical slots and must fit every expert at
    least once. Deterministic (pure numpy argmax with index tiebreaks),
    so planner tests and the drill can assert exact assignments."""
    counts = np.maximum(np.asarray(counts, dtype=np.float64).reshape(-1), 0.0)
    E = counts.shape[0]
    total = ep * slots_per_shard
    if total < E:
        raise ValueError(f"{ep}x{slots_per_shard} slots cannot hold "
                         f"{E} experts")
    if prev_assign is None:
        prev_assign = [i % E for i in range(total)]
    if len(prev_assign) != total:
        raise ValueError("prev_assign length != ep * slots_per_shard")

    # uniform prior so an idle window (all-zero counts) still yields a
    # valid plan instead of dividing by zero
    load = counts if counts.sum() > 0 else np.ones(E)

    nrep = np.ones(E, dtype=np.int64)
    for _ in range(total - E):
        nrep[int(np.argmax(load / nrep))] += 1

    # replica units, heaviest first (LPT)
    units: List[tuple] = []                      # (unit_load, expert)
    for e in range(E):
        units.extend([(load[e] / nrep[e], e)] * int(nrep[e]))
    units.sort(key=lambda u: (-u[0], u[1]))

    shard_load = np.zeros(ep)
    shard_free = np.full(ep, slots_per_shard, dtype=np.int64)
    placed: List[List[int]] = [[] for _ in range(ep)]
    for unit, e in units:
        # least-loaded shard with a free slot, preferring shards that do
        # not already hold a replica of this expert (a same-shard twin
        # wastes the slot's balancing power)
        order = sorted(range(ep),
                       key=lambda s: (shard_free[s] <= 0,
                                      e in placed[s], shard_load[s], s))
        s = order[0]
        placed[s].append(e)
        shard_load[s] += unit
        shard_free[s] -= 1

    assign = [e for s in range(ep) for e in sorted(placed[s])]
    after = shard_loads(assign, load, ep)
    before = shard_loads(prev_assign, load, ep)
    mean = float(after.mean()) or 1.0
    max_unit = max(u for u, _ in units)
    moved = sum(int(a != b) for a, b in zip(assign, prev_assign))
    return RebalancePlan(
        assign=assign, nrep=[int(n) for n in nrep],
        imbalance_before=_imbalance(before),
        imbalance_after=_imbalance(after),
        max_unit_frac=max_unit / mean, moved_slots=moved)


def placement_tables(assign: Sequence[int], num_experts: int,
                     ep: int) -> Dict[str, np.ndarray]:
    """Routing tables for ``_grouped_moe_ep`` from a slot assignment.

    ``place_dest``/``place_slot`` are ``[E, R]`` with ``R = len(assign)``
    (static, so replica count changes never retrace the jit); replica
    columns past ``place_nrep[e]`` repeat the real ones, but the sender
    indexes ``rep % nrep[e]`` so they are never load-bearing.
    """
    assign = list(assign)
    total = len(assign)
    slots = total // ep
    dest = np.zeros((num_experts, total), dtype=np.int32)
    slot = np.zeros((num_experts, total), dtype=np.int32)
    nrep = np.zeros(num_experts, dtype=np.int32)
    homes: List[List[tuple]] = [[] for _ in range(num_experts)]
    for i, e in enumerate(assign):
        homes[e].append((i // slots, i % slots))
    for e, h in enumerate(homes):
        if not h:
            raise ValueError(f"expert {e} has no slot in the assignment")
        nrep[e] = len(h)
        for r in range(total):
            d, sl = h[r % len(h)]
            dest[e, r] = d
            slot[e, r] = sl
    return {"place_dest": dest, "place_slot": slot, "place_nrep": nrep}


def apply_placement(mlp: Dict[str, Any], assign: Sequence[int],
                    num_experts: int, ep: int, *,
                    prev_assign: Optional[Sequence[int]] = None,
                    expert_axis: int = 0) -> Dict[str, Any]:
    """Rewrite an MoE weight dict into physical slot order plus tables.

    Expert-stacked leaves (everything but ``router`` and the tables) are
    gathered along ``expert_axis`` with ``torch.index_select`` so physical
    slot ``i`` holds an exact copy of expert ``assign[i]``. When
    ``prev_assign`` is given the leaves are ALREADY in that physical order
    and each expert is sourced from its first previous replica -- no
    logical-order copy is ever materialized. The tables are int32 tensors
    on the device of the dict's first tensor. Returns a new dict.
    """
    import torch

    assign = list(assign)
    if prev_assign is None:
        src = {e: e for e in range(num_experts)}
    else:
        src = {}
        for i, e in enumerate(prev_assign):
            src.setdefault(e, i)
        missing = [e for e in range(num_experts) if e not in src]
        if missing:
            raise ValueError(f"prev_assign lost experts {missing}")
    device = next((v.device for v in mlp.values()
                   if isinstance(v, torch.Tensor)), None)
    idx = torch.tensor([src[e] for e in assign], dtype=torch.int64,
                       device=device)

    out: Dict[str, Any] = {}
    tables = placement_tables(assign, num_experts, ep)
    for name, leaf in mlp.items():
        if name == "router" or name in tables:
            out[name] = leaf
        else:
            out[name] = torch.index_select(leaf, expert_axis, idx)
    for name, table in tables.items():
        out[name] = torch.as_tensor(table, device=device)
    return out
