"""Continuous-batching inference engine over a paged KV pool (counterpart of
``deepspeed_tpu/inference/engine_v2.py`` ``InferenceEngineV2``).

Ported scope: everything the reference engine does on one device, MoE
models included. Weights in the compute dtype or int8/int4
(``weight_dtype``: kernels G/H through the model's ``linear()`` seam; an
MoE model's expert stacks as int8 leaf pairs that the dispatch
dequantizes).
Three engines, as the reference's flags pick them:

* ``paged=True, packed=True`` (default): a KV pool in the compute dtype or
  int8/int4 with per-token scales (``kv_dtype``: the int modes of kernels
  A/B). ``put`` runs fresh whole prompts through ``forward_prefill``
  (flash kernel D) and everything else through the packed step
  ``forward_with_packed_cache`` (paged kernels A/B and the seeded flash
  C); ``decode_batch`` runs ``steps`` tokens, greedy or sampled
  (``temperature``/``top_k``/``top_p`` with a ``torch.Generator`` seeded
  from ``seed``), with the pool read-only and folds the new KV in once;
* ``packed=False``: the same pool, but ``put`` runs one dense
  ``[max_sequences, t_max]`` tile (every slot a row) through
  ``forward_with_paged_cache`` (kernel I), unchunked;
* ``paged=False``: a dense ``[L, max_sequences, max_seq_len, K, d]``
  cache and the same tile through ``forward_with_cache`` (plain torch
  attention, as the reference's is XLA).

The last two take bf16 KV only and have no ``decode_batch`` (the
reference's raises). The packed engine also carries the serving features:

* ``prefix_cache=``: a radix :class:`~deepspeed_tpu_torch.inference.
  ragged.PrefixCache` over full blocks; a fresh prompt attaches its cached
  prefix and only the suffix is prefilled (kernels B and C over the shared
  blocks). With ``tiers`` enabled, evicted cache blocks are demoted to a
  :class:`~deepspeed_tpu_torch.inference.kv_tier.KVTierStore` (host, then
  NVMe through the ``async_io`` library) and promoted back on a match;
* ``speculative=``: n-gram self-drafting in greedy ``decode_batch``, each
  round's drafts verified in one packed step;
* ``pause_request`` / ``resume_request`` park a live sequence's KV in the
  tier store and bring it back; ``export_paused`` / ``adopt_paused`` move
  a paused request to another engine through a durable manifest.

Promotions and resumes are uploaded into the pool by an in-place
``index_copy_`` ahead of the next step, on the same stream (the reference
fuses them into its step's prologue). Host-side scheduling (slots, blocks,
block tables, atom packing) mirrors the reference line for line, and so do
its instruments: the event-bus spans and instants (``engine`` and
``kv_tier`` categories), the prefix-cache and tier registry families, the
opt-in ``inference/*`` stream of :meth:`InferenceEngineV2.enable_metrics`
and the fault-injector sites of pause export and resume. The one
difference: the port never fuses a promote into a step, so it emits no
``promote_fence_fused`` instant and ``inference/decode_prologue_promotes``
stays 0.

MoE: on a grouped-dispatch model the engine resolves ``moe_kernel``
(argument, else the model's) and binds it into ``model.moe_fn``, as the
reference does; ``moe_a2a_bits``, ``moe_a2a_slice`` and
``moe_replica_slots`` shape expert parallelism, which one device never
enters, so they are accepted and change nothing, and ``rebalance_moe``
returns None. ``enable_metrics`` on an MoE model installs the expert-load
tracker (``moe/expert_tokens``, ``moe/imbalance``; one device-to-host copy
of E counts a layer a forward).

Not ported yet (they raise): meshes / tensor parallelism, and with them
expert parallelism.
"""

from __future__ import annotations

import functools
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.config.config import (PrefixCacheConfig,
                                               SpeculativeConfig)
from deepspeed_tpu_torch.inference.engine import sample_token
from deepspeed_tpu_torch.inference.quant import quantize_serving_params
from deepspeed_tpu_torch.inference.ragged import (CapacityError, PrefixCache,
                                                  SequenceManager)
from deepspeed_tpu_torch.models.transformer import (QuantizedWeight,
                                                    TransformerLM, torch_dtype)
from deepspeed_tpu_torch.observability.events import get_bus
from deepspeed_tpu_torch.ops.paged_attention import cache_append
from deepspeed_tpu_torch.utils import resolve_device

logger = logging.getLogger(__name__)

# packed-row atom layout: 1-token chunks are decode atoms; longer chunks
# each occupy one whole-chunk atom of bucketed width
_MIN_TILE = 32


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantizedWeight):
        return QuantizedWeight(fn(tree.packed), fn(tree.scales), tree.bits,
                               tree.din)
    return fn(tree)


def _quant_bits(tree) -> set:
    """The ``bits`` of every :class:`QuantizedWeight` leaf of ``tree``."""
    if isinstance(tree, dict):
        return set().union(*(_quant_bits(v) for v in tree.values()))
    return {tree.bits} if isinstance(tree, QuantizedWeight) else set()


def _coerce(cls, v):
    """A feature section from None (off), a bool, a dict or an instance."""
    if v is None:
        return cls()
    if isinstance(v, cls):
        return v
    if isinstance(v, bool):
        return cls(enabled=v)
    return cls.build(dict(v), cls.__name__)


def _host_view(t: torch.Tensor) -> np.ndarray:
    """A CPU tensor as a numpy array sharing its memory; bf16 (which numpy
    lacks) as its int16 bit pattern."""
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _unported(what: str, item: str):
    return NotImplementedError(
        f"InferenceEngineV2: {what} is not ported yet (ROADMAP section 1, "
        f"{item})")


class _PausedSeq:
    """A paused sequence: the tier-store keys of its KV pages, the frontier
    to restore and its committed-token history. Keys are negative, apart
    from the prefix cache's non-negative handles in a shared store."""

    __slots__ = ("uid", "keys", "seen", "hist", "resuming", "adopted",
                 "durable", "manifest_path")

    def __init__(self, uid: int, keys, seen: int, hist):
        self.uid = uid
        self.keys = list(keys)
        self.seen = int(seen)
        self.hist = hist
        self.resuming = False
        # migration: an adopted record's tier reads fault through the
        # migrate site; the exported durable entries and the manifest are
        # reclaimed when the record dies here
        self.adopted = False
        self.durable = None
        self.manifest_path = None


class InferenceEngineV2:
    def __init__(self, model: TransformerLM, params=None,
                 max_sequences: int = 8, max_seq_len: Optional[int] = None,
                 block_size: int = 128, num_blocks: Optional[int] = None,
                 paged: bool = True, packed: bool = True,
                 kv_dtype: str = "bf16", weight_dtype: str = "bf16",
                 prefix_cache=None, speculative=None,
                 device="cuda", seed: int = 0, topology=None,
                 mesh: Optional[dict] = None,
                 moe_kernel: Optional[str] = None,
                 moe_a2a_bits: Optional[int] = None,
                 moe_a2a_slice: Optional[int] = None,
                 moe_replica_slots: int = 0):
        if topology is not None or mesh is not None:
            raise _unported("a mesh / tensor parallelism (topology=, mesh=)",
                            '"Mesh, ZeRO and tensor parallelism"')
        if weight_dtype not in ("bf16", "int8", "int4"):
            raise ValueError(f"weight_dtype must be bf16|int8|int4, got "
                             f"{weight_dtype!r}")
        if kv_dtype not in ("bf16", "int8", "int4"):
            raise ValueError(f"kv_dtype must be bf16|int8|int4, got "
                             f"{kv_dtype!r}")
        if kv_dtype != "bf16" and not (paged and packed):
            raise ValueError("quantized KV needs the packed paged engine")
        self.paged = paged
        self.packed = packed and paged
        self.device = resolve_device(device)
        self.module = model
        self.cfg = model.cfg
        self.max_seq_len = max_seq_len or self.cfg.max_seq_len
        self.state = SequenceManager(max_sequences, self.max_seq_len,
                                     block_size, num_blocks=num_blocks)
        # MoE: the grouped product's kernel is resolved once and bound into
        # the model's moe_fn (the reference's :200-218). The a2a wire
        # format and replica slots shape expert parallelism, which needs an
        # "ep" mesh axis: on one device they ride the partial unused.
        self.moe_kernel: Optional[str] = None
        self.moe_kernel_reason = ""
        self._moe_tracker = None
        if self.cfg.num_experts > 1 and self.cfg.moe_dispatch == "grouped":
            from deepspeed_tpu_torch.moe import sharded_moe

            self.moe_kernel, self.moe_kernel_reason = \
                sharded_moe.resolve_moe_kernel(
                    self.cfg.moe_kernel if moe_kernel is None
                    else moe_kernel)
            model.moe_fn = functools.partial(
                sharded_moe.grouped_moe_mlp_block, kernel=self.moe_kernel,
                a2a_bits=int(self.cfg.moe_a2a_bits if moe_a2a_bits is None
                             else moe_a2a_bits),
                a2a_slice=int(self.cfg.moe_a2a_slice if moe_a2a_slice is None
                              else moe_a2a_slice))
        cdt = torch_dtype(self.cfg.dtype)
        if params is None:
            params = model.init(seed=seed, device=self.device)
        # a tree quantized already (a warm start's published serving tree)
        # is served as it is, at the width it was quantized to
        held = _quant_bits(params)
        want = {"bf16": set(), "int8": {8}, "int4": {4}}[weight_dtype]
        if held and held != want:
            raise ValueError(
                f"params hold int{'/int'.join(map(str, sorted(held)))} "
                f"weights, weight_dtype is {weight_dtype!r}")
        # serving holds weights in the compute dtype (the reference's
        # _serve_cast): fp32 leaves are cast once, here
        params = _tree_map(
            lambda p: p.to(device=self.device,
                           dtype=cdt if p.dtype == torch.float32 else p.dtype),
            params)
        if weight_dtype != "bf16" and not held:
            # decode reads every weight once a step: packed leaves cut those
            # bytes 2x (int8) / 4x (int4); the forward paths pick them up
            # through the model's linear() seam
            params = quantize_serving_params(
                params, self.cfg, bits=4 if weight_dtype == "int4" else 8)
        self.params = params
        # host split of the last put (ms): batch building, dispatch, device
        # step + logits to host
        self.timing: Dict[str, float] = {}
        self._obs = None    # opt-in inference/* registry stream
        # causal event bus, cached: configure_tracing mutates the singleton
        # in place, so a disabled bus costs one attribute check a site
        self._ebus = get_bus()
        self.block_size = block_size
        self.nb_max = -(-self.max_seq_len // block_size)
        if paged:
            self.num_blocks = self.state.allocator.num_blocks
            self.cache = model.init_paged_kv_cache(
                self.num_blocks, block_size, device=self.device,
                quantize=kv_dtype != "bf16",
                bits=4 if kv_dtype == "int4" else 8)
            self._pos = np.zeros((max_sequences,), np.int32)
        else:
            self.cache = model.init_kv_cache(max_sequences, self.max_seq_len,
                                             device=self.device)
        self._bt_cache: Optional[np.ndarray] = None
        self._bt_key: Dict[int, tuple] = {}
        # ---- prefix cache, speculative decoding, tiers, pause/resume ----
        self.prefix_cfg = _coerce(PrefixCacheConfig, prefix_cache)
        self.spec_cfg = _coerce(SpeculativeConfig, speculative)
        if (self.prefix_cfg.enabled or self.spec_cfg.enabled) \
                and not self.packed:
            raise ValueError("prefix_cache / speculative need the packed "
                             "paged engine (paged=True, packed=True)")
        self.prefix_cache: Optional[PrefixCache] = None
        # host buffers of the tier store are page-locked on the card
        self._pin = self.device.type == "cuda"
        # tier store of demoted blocks and paused requests; promotions
        # awaiting their upload into the pool
        self._tier_store = None
        self._promote_q: list = []
        # paused requests park their KV in the same store under negative
        # keys; their uploads ride the same fence
        self._paused: Dict[int, _PausedSeq] = {}
        self._pause_q: list = []        # resume uploads awaiting the fence
        self._resume_failed: list = []  # uids whose resume tier read failed
        self._pause_key = -1
        # host budget of the store the pause path creates when prefix
        # tiers are off, and the shared migration namespace that gives it
        # an NVMe tier (both set by a serving layer before the first pause)
        self.pause_store_mb = 64.0
        self.migration_nvme_path = ""
        # promote latency per tier (tiers on), observed at the upload fence
        self._promote_ms = None
        if self.prefix_cfg.enabled:
            from deepspeed_tpu_torch.observability import get_registry

            r = get_registry()
            inst = {
                "hits": r.counter("inference/prefix_cache_hits",
                                  "requests that attached a cached prefix"),
                "misses": r.counter("inference/prefix_cache_misses",
                                    "prefix lookups that matched nothing"),
                "hit_tokens": r.counter(
                    "inference/prefix_cache_hit_tokens",
                    "prompt tokens served from cached KV (prefill skipped)"),
                "evictions": r.counter(
                    "inference/prefix_cache_evictions",
                    "cached blocks evicted (LRU, under pool pressure)"),
                "blocks": r.gauge("inference/prefix_cache_blocks",
                                  "blocks currently held by the prefix tree"),
            }
            tiers = self.prefix_cfg.tiers
            if tiers.enabled:
                inst["tier_hits_hbm"] = r.counter(
                    "inference/prefix_cache_tier_hits",
                    "cached blocks served per tier on a radix match",
                    labels={"tier": "hbm"})
            self.prefix_cache = PrefixCache(
                self.state.allocator, max_blocks=self.prefix_cfg.max_blocks,
                instruments=inst)
            self.state.prefix_cache = self.prefix_cache
            if tiers.enabled:
                from deepspeed_tpu_torch.inference.kv_tier import KVTierStore

                tier_inst = {}
                for t in ("host", "nvme"):
                    tier_inst[t] = {
                        "hits": r.counter(
                            "inference/prefix_cache_tier_hits",
                            "cached blocks served per tier on a radix match",
                            labels={"tier": t}),
                        "misses": r.counter(
                            "inference/prefix_cache_tier_misses",
                            "tier entries lost or unreadable (recomputed)",
                            labels={"tier": t}),
                        "demotions": r.counter(
                            "inference/prefix_cache_tier_demotions",
                            "cache blocks demoted into the tier",
                            labels={"tier": t}),
                        "bytes": r.gauge(
                            "inference/prefix_cache_tier_bytes",
                            "KV bytes resident in the tier",
                            labels={"tier": t}),
                    }
                self._promote_ms = {
                    t: r.histogram(
                        "inference/prefix_cache_tier_promote_ms",
                        "demoted-block promote latency: tier fetch start "
                        "to pool upload dispatched", labels={"tier": t})
                    for t in ("host", "nvme")}
                self._tier_store = KVTierStore(
                    host_mb=tiers.host_mb, nvme_path=tiers.nvme_path,
                    promote_depth=tiers.promote_depth,
                    nvme_max_mb=tiers.nvme_max_mb,
                    nvme_ttl_s=tiers.nvme_ttl_s, instruments=tier_inst,
                    pin=self._pin)
                self.prefix_cache.attach_tier_store(self._tier_store,
                                                    self._extract_blocks)
        # per-uid committed-token history (keys prefix publication and
        # n-gram drafts); None when both features are off
        self._hist: Optional[Dict[int, np.ndarray]] = (
            {} if (self.prefix_cfg.enabled or self.spec_cfg.enabled)
            else None)
        self.spec_stats: Dict[str, int] = {
            "rounds": 0, "drafted": 0, "accepted": 0, "emitted": 0,
            "fallback_steps": 0,
            # verify rounds run through put's packed step (the kernels)
            "fused": 1,
        }

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def enable_metrics(self, registry=None) -> None:
        """Opt-in ``inference/*`` registry stream of the packed put path and
        ``decode_batch`` (host-build and device-step + fetch latency
        histograms, token counters). Off by default: with it off the put
        path pays one ``is None`` check. Every reading is a host clock
        around work the call already waits on (the logits or tokens to
        host): no synchronisation is added, but on an MoE model, whose
        expert-load tracker (``moe/*``, process-wide, installed here) copies
        each layer's E counts to the host, one sync a layer a forward."""
        from deepspeed_tpu_torch.observability import get_registry

        r = registry if registry is not None else get_registry()
        self._obs = {
            "put_host_ms": r.histogram(
                "inference/put_host_ms",
                "put(): host batch building (ms)"),
            "put_fetch_ms": r.histogram(
                "inference/put_fetch_ms",
                "put(): device step + logits D2H (ms)"),
            "tokens": r.counter("inference/tokens",
                                "tokens pushed through put()"),
            "decode_dispatches": r.counter(
                "inference/decode_dispatches",
                "fused decode-scan device dispatches (decode_batch)"),
            "decode_tokens": r.counter(
                "inference/decode_tokens",
                "tokens generated by decode_batch scans"),
            "decode_fetch_ms": r.histogram(
                "inference/decode_fetch_ms",
                "decode_batch: device scan + token D2H (ms)"),
            "decode_prologue_promotes": r.counter(
                "inference/decode_prologue_promotes",
                "tier promotions folded into a fused step prologue"),
        }
        if self.cfg.num_experts > 1:
            from deepspeed_tpu_torch.moe import balancer, sharded_moe

            self._moe_tracker = balancer.ExpertLoadTracker(
                self.cfg.num_experts, registry=r)
            sharded_moe.set_expert_tracker(self._moe_tracker)
            self._obs["moe_rebalances"] = r.counter(
                "moe/rebalances", "applied expert placement rebalances")

    def rebalance_moe(self, counts=None, min_gain: float = 0.0):
        """The AutoEP control step: re-place experts over the expert-
        parallel shards from observed load. One device has no expert-
        parallel placement, so there is nothing to move: None, as the
        reference returns without an "ep" mesh axis (its :523-524)."""
        return None

    def _observe_put(self, chunks) -> None:
        if self._obs is not None:
            self._obs["put_host_ms"].observe(self.timing["host_ms"])
            self._obs["put_fetch_ms"].observe(self.timing["fetch_ms"])
            self._obs["tokens"].inc(float(sum(len(c) for c in chunks)))

    # ---- scheduling surface ----------------------------------------------
    def query(self, uid: int, n_tokens: int) -> bool:
        return self.state.can_schedule(uid, n_tokens)

    def flush(self, uids: Sequence[int]) -> None:
        for uid in uids:
            seq = self.state.sequences.get(uid)
            if seq is not None:
                if self.paged:
                    self._pos[seq.slot] = 0
                else:
                    self.cache["pos"][seq.slot] = 0
            self.state.flush(uid)
            if self._hist is not None:
                self._hist.pop(uid, None)
            if self._paused:
                # a paused request ending here takes its parked entries
                self._drop_paused(uid)

    # ---- prefix-cache KV reuse -------------------------------------------
    def prefix_attach(self, uid: int, tokens) -> int:
        """Attach the longest cached full-block prefix of ``tokens`` to the
        fresh sequence ``uid`` (shared blocks, reference taken) so only the
        uncached suffix is prefilled. Capped at ``len(tokens) - 1`` so one
        token always runs through the model. Returns matched tokens (0 =
        miss or feature off)."""
        if self.prefix_cache is None or uid in self.state.sequences:
            return 0
        toks = np.atleast_1d(np.asarray(tokens, np.int32))
        if len(toks) < 2:
            return 0
        blocks, n = self.prefix_cache.acquire(toks, max_tokens=len(toks) - 1)
        recs: list = []
        try:
            # promotions this acquire started fence at the next step; an
            # attach failure re-demotes them (their blocks hold garbage)
            recs = self.prefix_cache.drain_promotes()
            if n == 0:
                return 0
            seq = self.state.attach_prefix(uid, blocks, n)
        except BaseException:
            if blocks:
                self.state.allocator.free(blocks)
            if recs:
                self.prefix_cache.cancel_promotes(recs)
            raise
        self._promote_q.extend(recs)
        self._pos[seq.slot] = n
        if self._hist is not None:
            self._hist[uid] = toks[:n].copy()
        bus = self._ebus
        if bus.enabled and (n or recs):
            # the uid <-> KV-tier join point: a demoted prefix attaching
            # here is the event that explains a cheap TTFT
            bus.instant("engine", "prefix_attach",
                        args={"uid": int(uid), "hit_tokens": int(n),
                              "promotes": len(recs)})
            if recs:
                bus.instant("kv_tier", "promote_attach",
                            args={"uid": int(uid), "blocks": len(recs),
                                  "tiers": sorted({r.tier for r in recs})})
        return n

    def _commit(self, uid: int, fed) -> None:
        """Commit one scheduled chunk: advance ``seen_tokens``, extend the
        token history and publish newly completed full blocks to the prefix
        tree (shared from then on, never written again)."""
        self.state.commit(uid)
        if self._hist is not None:
            arr = np.atleast_1d(np.asarray(fed, np.int32))
            h = self._hist.get(uid)
            self._hist[uid] = (arr.copy() if h is None
                               else np.concatenate([h, arr]))
        if self.prefix_cache is not None:
            seq = self.state.sequences.get(uid)
            if seq is not None:
                n_full = seq.seen_tokens // self.block_size
                if n_full > seq.published:
                    self.prefix_cache.insert(
                        self._hist[uid][:n_full * self.block_size],
                        seq.blocks[:n_full])
                    seq.published = n_full

    def prefix_cache_report(self) -> Optional[Dict]:
        return (None if self.prefix_cache is None
                else self.prefix_cache.report())

    # ---- tiered KV: demote (extract) and promote (upload) ----------------
    def _extract_blocks(self, blocks: Sequence[int]) -> list:
        """The listed pool blocks' KV pages on the host, one gather and one
        (synchronous) copy per pool part: the copy is complete when this
        returns, before the tier store reads the arrays. Returns one
        ``{part: ndarray}`` payload per block (bf16 as int16 bits)."""
        idx = torch.as_tensor(np.asarray(blocks, np.int64), device=self.device)
        pages = {name: _host_view(t.index_select(1, idx).cpu())
                 for name, t in self.cache.items()}
        return [{name: arr[:, i] for name, arr in pages.items()}
                for i in range(len(blocks))]

    def _stage(self, fetches):
        """Host pages for one block per fetch, every pool part, in buffers
        of the tier store's pool (page-locked on the card), filled from the
        fetches (their waits happen here). A failed read leaves its block
        zeroed. Returns ``(pages, buffers, failures)``: the buffers go back
        with :meth:`_unstage` once the pages are uploaded; ``failures``
        lists ``(index, exception)``."""
        pool = self._tier_store.pool
        pages, bufs = {}, []
        for name, t in self.cache.items():
            shape = (t.shape[0], len(fetches)) + tuple(t.shape[2:])
            nbytes = t.element_size() * int(np.prod(shape))
            bufs.append(pool.get(nbytes))
            pages[name] = bufs[-1].tensor(nbytes).view(t.dtype).view(shape)
        views = {name: _host_view(t) for name, t in pages.items()}
        failures = []
        for i, fetch in enumerate(fetches):
            try:
                parts = fetch.wait()
            except Exception as e:
                # any error, not only IO (a lazy NVMe read submits inside
                # wait()): the later fetches must still be waited for
                failures.append((i, e))
                for arr in views.values():
                    arr[:, i] = 0
                continue
            for name, arr in views.items():
                arr[:, i] = parts[name]
        return pages, bufs, failures

    def _unstage(self, bufs) -> None:
        for buf in bufs:
            self._tier_store.pool.put(buf)

    def _promote_impl(self, idx: Sequence[int],
                      pages: Dict[str, torch.Tensor]) -> None:
        """Upload staged pages into pool blocks ``idx``: one in-place
        ``index_copy_`` per pool part on the current stream, ahead of the
        step that reads them. The host-to-card copy is synchronous, so the
        staging (and the fetches it was filled from) may be reused at
        once."""
        dev_idx = torch.as_tensor(np.asarray(idx, np.int64),
                                  device=self.device)
        for name, host in pages.items():
            self.cache[name].index_copy_(1, dev_idx, host.to(self.device))

    def _flush_promotes(self) -> None:
        """The promote fence, run before every step: pending resumes first
        (their blocks must be whole before any read), then every queued
        prefix promotion. A promotion whose tier read failed uploads zeros
        (loudly) and its node leaves the tree."""
        if self._pause_q:
            self._flush_pause_promotes()
        recs, self._promote_q = self._promote_q, []
        if not recs:
            return
        bus = self._ebus
        if not bus.enabled:
            return self._flush_promotes_impl(recs)
        with bus.span("engine", "promote_fence",
                      args={"pending": len(recs)}):
            return self._flush_promotes_impl(recs)

    def _flush_promotes_impl(self, recs) -> None:
        built = self._build_promote_payloads(recs)
        if built is None:
            return
        recs, failed, pages, bufs = built
        try:
            self._promote_impl([r.block for r in recs], pages)
        except BaseException:
            # never uploaded: re-demote onto the intact tier entries
            self.prefix_cache.cancel_promotes(recs)
            raise
        finally:
            self._unstage(bufs)
        self._finish_promotes(recs, failed)

    def _build_promote_payloads(self, recs):
        """Drop stale records (a ``clear()`` since the attach released
        their blocks, which may belong to another sequence now) and stage
        the rest's pages (the fetch waits happen here). Returns ``(recs,
        failed, pages, buffers)``, or None when every record was stale."""
        stale = [r for r in recs if r.epoch != self.prefix_cache.epoch]
        if stale:
            for rec in stale:
                rec.fetch.release()
                self._tier_store.discard(rec.key)
            recs = [r for r in recs if r.epoch == self.prefix_cache.epoch]
            if not recs:
                return None
        pages, bufs, failures = self._stage([r.fetch for r in recs])
        failed = []
        for i, e in failures:
            rec = recs[i]
            logger.warning(f"kv tier: promote read failed for block "
                           f"{rec.block} ({e}); zero-filling")
            self._tier_store.count_miss(rec.tier)
            failed.append(rec)
        return recs, failed, pages, bufs

    def _finish_promotes(self, recs, failed) -> None:
        """After the upload: return the fetch loans, drop the store entries
        and publish the uploaded nodes; a zero-filled node leaves the tree
        (it serves only its in-flight acquirer). Observes each uploaded
        block's promote latency (a failed read counts as a tier miss, not a
        promote)."""
        now = time.perf_counter()
        for rec in recs:
            rec.fetch.release()
            self._tier_store.discard(rec.key)
            if self._promote_ms is not None and rec not in failed:
                self._promote_ms[rec.tier].observe(
                    (now - rec.fetch.t_start) * 1e3)
        self.prefix_cache.mark_uploaded(recs)
        for rec in failed:
            self.prefix_cache.drop_failed_promote(rec.node)

    def _fence(self) -> None:
        if self._promote_q or self._pause_q:
            self._flush_promotes()

    def tier_report(self) -> Optional[Dict]:
        """Tier-store snapshot and pending promote depth (None: no store)."""
        if self._tier_store is None:
            return None
        return {**self._tier_store.report(),
                "pending_promotes": len(self._promote_q),
                "paused_requests": len(self._paused),
                "pending_resumes": len(self._pause_q),
                # the reference fuses uploads into its step's prologue;
                # the port uploads ahead of the step
                "fused_prologue_dispatches_saved": 0}

    # ---- serving preemption: pause / resume through the tier store -------
    def _ensure_pause_store(self):
        """The pause path's tier store, created on first use when prefix
        tiers are off (host only, or with the shared migration NVMe path)."""
        if self._tier_store is None:
            from deepspeed_tpu_torch.inference.kv_tier import KVTierStore

            self._tier_store = KVTierStore(
                host_mb=float(self.pause_store_mb),
                nvme_path=self.migration_nvme_path or "", pin=self._pin)
        elif self.migration_nvme_path:
            self._tier_store.attach_nvme(self.migration_nvme_path)
        return self._tier_store

    def is_paused(self, uid: int) -> bool:
        return uid in self._paused

    def paused_blocks(self, uid: int) -> int:
        """Pool blocks a paused uid needs back to resume (0 = not paused)."""
        rec = self._paused.get(uid)
        return 0 if rec is None else len(rec.keys)

    def can_resume(self, uid: int) -> bool:
        """A free slot and enough free-or-evictable blocks to resume."""
        rec = self._paused.get(uid)
        if rec is None or rec.resuming:
            return False
        return (bool(self.state._free_slots)
                and len(rec.keys) <= self.state._available_blocks())

    def pause_request(self, uid: int) -> bool:
        """Preempt a live sequence: demote its KV pages into the tier store
        (the prefix demotion's byte path) and free its blocks and slot as a
        flush does. False, with no side effects, when the uid has nothing
        pausable (unknown, paused, mid-step, empty) or the store refuses
        the pages."""
        if not self.packed:
            return False
        seq = self.state.sequences.get(uid)
        if seq is None or uid in self._paused or seq.in_flight:
            return False
        seen = int(seq.seen_tokens)
        if seen <= 0:
            return False
        t0 = time.perf_counter()
        nb = -(-seen // self.block_size)
        store = self._ensure_pause_store()
        payloads = self._extract_blocks(seq.blocks[:nb])
        keys = []
        for parts in payloads:
            key = self._pause_key
            self._pause_key -= 1
            if not store.put(key, parts):
                for k in keys:
                    store.discard(k)
                return False
            keys.append(key)
        hist = self._hist.get(uid) if self._hist is not None else None
        self._paused[uid] = _PausedSeq(uid, keys, seen, hist)
        # shared prefix blocks just lose this sequence's reference: the
        # snapshot above holds their bytes, so resume never needs the tree
        self._pos[seq.slot] = 0
        self.state.flush(uid)
        if self._hist is not None:
            self._hist.pop(uid, None)
        bus = self._ebus
        if bus.enabled:
            bus.instant("kv_tier", "pause",
                        args={"uid": int(uid), "blocks": nb,
                              "seen_tokens": seen,
                              "ms": round((time.perf_counter() - t0) * 1e3,
                                          3)})
        return True

    def resume_request(self, uid: int) -> bool:
        """Begin resuming a paused uid: a fresh slot and blocks, tier reads
        started; the upload fences before the next step. False when there
        is no capacity yet, or when the parked entries were lost (the uid
        then goes on the list :meth:`flush_resumes` drains)."""
        rec = self._paused.get(uid)
        if rec is None or rec.resuming or self._tier_store is None:
            return False
        if not self.can_resume(uid):
            return False
        store = self._tier_store
        try:
            seq = self.state.restore(uid, len(rec.keys), rec.seen)
        except (RuntimeError, ValueError):
            return False
        fetches = []
        store.begin_chain(rec.keys)
        try:
            for key in rec.keys:
                f = store.fetch_start(key)
                if f is None:         # entry dropped under store pressure
                    raise KeyError(key)
                fetches.append(f)
        except BaseException:
            for f in fetches:
                f.release()
            store.end_chain()
            # the parked KV is gone: unwind the restore (never resume on
            # zeros) and report the loss
            self._pos[seq.slot] = 0
            self.state.flush(uid)
            self._drop_paused(uid)
            self._resume_failed.append(uid)
            return False
        store.end_chain()
        rec.resuming = True
        self._pos[seq.slot] = rec.seen
        if self._hist is not None and rec.hist is not None:
            self._hist[uid] = rec.hist
        self._pause_q.append((uid, rec, list(seq.blocks), fetches))
        bus = self._ebus
        if bus.enabled:
            bus.instant("kv_tier", "resume_start",
                        args={"uid": int(uid), "blocks": len(rec.keys),
                              "seen_tokens": rec.seen})
        return True

    # ---- cross-engine migration: durable export / adopt ------------------
    def export_paused(self, uid: int, tag: str, shared_path: str,
                      keep: bool = True) -> Optional[str]:
        """Write a durable resume manifest for a paused uid into the shared
        migration namespace; returns its path (None: not exportable --
        unknown or resuming uid, or a store whose NVMe tier is not
        ``<shared_path>/kv``). ``tag`` must be unique across engines. With
        ``keep`` this engine keeps its entries and reclaims the durable
        copy when the record dies here; ``keep=False`` hands ownership to
        the manifest."""
        rec = self._paused.get(uid)
        if rec is None or rec.resuming:
            return None
        if rec.manifest_path is not None:
            path = rec.manifest_path            # idempotent re-export
            if not keep:
                rec.durable = None
                rec.manifest_path = None
            return path
        store = self._tier_store
        if store is None or store.swapper is None:
            return None
        if os.path.realpath(store.swapper.swap_dir) != os.path.realpath(
                os.path.join(shared_path, "kv")):
            return None             # spills where other engines cannot see
        from deepspeed_tpu_torch.inference.kv_tier import write_manifest
        from deepspeed_tpu_torch.resilience.faults import get_injector

        inj = get_injector()
        t0 = time.perf_counter()
        entries = store.export_durable(rec.keys, tag)
        try:
            if inj:
                # the window the manifest protocol closes: KV bytes durable,
                # no manifest yet (orphaned files, never a manifest
                # pointing at nothing)
                inj.on_pause_export(str(tag))
            hist = rec.hist
            payload = {
                "uid": str(tag),
                "seen_tokens": int(rec.seen),
                "hist": ([] if hist is None
                         else [int(t) for t in np.asarray(hist).tolist()]),
                "entries": entries,
            }
            path = write_manifest(shared_path, payload)
        except BaseException:
            store.drop_durable(entries)
            raise
        if inj:
            inj.maybe_tear_manifest(path, str(tag))
        if keep:
            rec.durable = entries
            rec.manifest_path = path
        bus = self._ebus
        if bus.enabled:
            bus.instant("kv_tier", "pause_export",
                        args={"uid": int(uid), "tag": str(tag),
                              "entries": len(entries), "keep": bool(keep),
                              "ms": round((time.perf_counter() - t0) * 1e3,
                                          3)})
        return path

    def adopt_paused(self, uid: int, payload: Dict,
                     manifest_path: Optional[str] = None) -> None:
        """Register another engine's exported pause record under the local
        ``uid``: its durable entries become NVMe entries of this engine's
        store and the uid resumes like a locally paused one. Raises on any
        validation failure with the partial adopt unwound.
        ``manifest_path`` (the claimed manifest) is removed when the record
        dies."""
        if uid in self._paused or uid in self.state.sequences:
            raise ValueError(f"adopt_paused: uid {uid} already live")
        store = self._ensure_pause_store()
        if store.swapper is None:
            raise RuntimeError("adopt_paused requires a shared NVMe "
                               "namespace (migration_nvme_path)")
        entries = payload.get("entries") or []
        seen = int(payload.get("seen_tokens", 0))
        if seen <= 0 or not entries:
            raise ValueError("adopt_paused: empty manifest payload")
        keys = []
        for _ in entries:
            keys.append(self._pause_key)
            self._pause_key -= 1
        store.adopt_durable(entries, keys)
        hist = payload.get("hist") or None
        rec = _PausedSeq(uid, keys, seen,
                         None if hist is None
                         else np.asarray(hist, np.int32))
        rec.adopted = True
        rec.manifest_path = manifest_path
        self._paused[uid] = rec
        bus = self._ebus
        if bus.enabled:
            bus.instant("kv_tier", "adopt",
                        args={"uid": int(uid),
                              "tag": str(payload.get("uid")),
                              "entries": len(keys), "seen_tokens": seen})

    def flush_resumes(self) -> list:
        """Upload pending resumes now; returns (and clears) the uids whose
        tier read failed."""
        self._flush_pause_promotes()
        failed, self._resume_failed = self._resume_failed, []
        return failed

    def _unwind_resume(self, uid: int, fetches) -> None:
        """A resume that cannot complete: give back loans, blocks, slot and
        parked entries; the uid goes on the resume-failure list."""
        for f in fetches:
            f.release()
        seq = self.state.sequences.get(uid)
        if seq is not None:
            self._pos[seq.slot] = 0
            self.state.flush(uid)
        if self._hist is not None:
            self._hist.pop(uid, None)
        self._drop_paused(uid)
        self._resume_failed.append(uid)

    def _fault_resume_reads(self, inj, rec) -> bool:
        """The fault injector's tier-read site of a resume, once for each
        parked key in order before its fetch is waited on: a migrate read
        for an adopted record, a resume read otherwise. True when an
        injected read failed."""
        fire = inj.on_migrate_read if rec.adopted else inj.on_resume_read
        for key in rec.keys:
            try:
                fire(self._tier_store.tier_of(key) or "host")
            except OSError as e:
                logger.warning(f"kv tier: resume read failed for uid "
                               f"{rec.uid} key {key} ({e}); unwinding")
                return True
        return False

    def _flush_pause_promotes(self) -> None:
        """Upload every pending resume's parked pages into its new blocks.
        A failed read never zero-fills here (a resumed sequence would decode
        from zeros as its own past): the resume is unwound instead."""
        pending, self._pause_q = self._pause_q, []
        if not pending:
            return
        from deepspeed_tpu_torch.resilience.faults import get_injector

        inj = get_injector()
        for j, (uid, rec, blocks, fetches) in enumerate(pending):
            if inj and self._fault_resume_reads(inj, rec):
                self._unwind_resume(uid, fetches)
                continue
            pages, bufs, failures = self._stage(fetches)
            if failures:
                i, e = failures[0]
                logger.warning(f"kv tier: resume read failed for uid {uid} "
                               f"key {rec.keys[i]} ({e}); unwinding")
                self._unstage(bufs)
                self._unwind_resume(uid, fetches)
                continue
            try:
                self._promote_impl(blocks, pages)
            except BaseException:
                # the pool was not touched: unwind this uid, requeue the rest
                self._unwind_resume(uid, fetches)
                self._pause_q = list(pending[j + 1:]) + self._pause_q
                raise
            finally:
                self._unstage(bufs)
            for f in fetches:
                f.release()
            self._drop_paused(uid)      # parked copies now redundant
            bus = self._ebus
            if bus.enabled:
                bus.instant("kv_tier", "resume_upload",
                            args={"uid": int(uid), "blocks": len(blocks)})

    def _drop_paused(self, uid: int) -> None:
        """Forget a pause record: release an in-flight resume's loans and
        discard its parked entries (and its exported durable copy).
        Idempotent."""
        rec = self._paused.pop(uid, None)
        if rec is None:
            return
        keep = []
        for item in self._pause_q:
            if item[0] == uid:
                for f in item[3]:
                    f.release()
            else:
                keep.append(item)
        self._pause_q = keep
        if self._tier_store is not None:
            for key in rec.keys:
                self._tier_store.discard(key)
            if rec.durable is not None:
                self._tier_store.drop_durable(rec.durable)
        if rec.manifest_path is not None:
            try:
                os.remove(rec.manifest_path)
            except OSError:
                pass                    # claimed or reclaimed elsewhere

    def close(self) -> None:
        """Idempotent teardown of the tier store (host buffers, swapper).
        Promotions never uploaded leave the prefix tree (their blocks hold
        garbage); the cache stays usable without tiers."""
        if self._promote_q:
            for rec in self._promote_q:
                rec.fetch.release()
                if self.prefix_cache is not None:
                    self.prefix_cache.drop_failed_promote(rec.node)
            self._promote_q = []
        if self._pause_q:
            for _uid, _rec, _blocks, fetches in self._pause_q:
                for f in fetches:
                    f.release()
            self._pause_q = []
        for uid in list(self._paused):
            self._drop_paused(uid)
        if self._tier_store is not None:
            self._tier_store.close()
            self._tier_store = None
            if self.prefix_cache is not None:
                self.prefix_cache.tier_store = None
                self.prefix_cache.extract_fn = None

    def _block_tables(self) -> np.ndarray:
        """[max_sequences, nb_max] physical block ids. Rows of live slots are
        correct (rebuilt only when a slot's block count or generation
        changed); unused tail entries point at the scratch block."""
        if self._bt_cache is None:
            self._bt_cache = np.full(
                (self.state.max_sequences, self.nb_max), self.num_blocks,
                np.int32)
        bt = self._bt_cache
        gen = self.state.slot_generation
        for seq in self.state.sequences.values():
            key = (gen[seq.slot], len(seq.blocks))
            if self._bt_key.get(seq.slot) != key:
                n = key[1]
                bt[seq.slot, :n] = seq.blocks
                bt[seq.slot, n:] = self.num_blocks
                self._bt_key[seq.slot] = key
        return bt

    def _fresh(self, uid: int) -> bool:
        seq = self.state.sequences.get(uid)
        return seq is None or self._pos[seq.slot] == 0

    # ---- whole-prompt prefill --------------------------------------------
    def _prefill_impl(self, ids, lengths, bt, slots):
        """Whole-prompt prefill + one in-place pool append per pool."""
        logits, kv = self.module.forward_prefill(self.params, ids, lengths)
        L, Bp, T = kv["k"].shape[:3]
        K, hd = self.cfg.num_kv_heads, self.cfg.head_dim
        slot2 = slots.repeat_interleave(T)
        pos2 = torch.arange(T, dtype=torch.int32, device=ids.device).repeat(Bp)
        valid2 = (torch.arange(T, device=ids.device)[None, :]
                  < lengths[:, None]).reshape(-1)
        cache_append(self.cache, kv["k"].reshape(L, Bp * T, K, hd),
                     kv["v"].reshape(L, Bp * T, K, hd), bt, slot2, pos2,
                     valid2)
        return logits

    # cap on bpad*T_pad per prefill step (bounds the [L, B, T, K, d] stash)
    PREFILL_BATCH_TOKENS = 16384

    def _prefill_whole(self, batch_uids: Sequence[int], chunks
                       ) -> Dict[int, np.ndarray]:
        """Fresh whole prompts: flash-prefill every prompt in one step (T
        padded to a power of two >= 32, the batch to a power of two)."""
        # this call's own host clock: the grouped recursion below runs
        # earlier groups' steps to completion first
        t_entry = time.perf_counter()
        if not self.state.can_schedule_batch(batch_uids,
                                             [len(c) for c in chunks]):
            raise CapacityError(batch_uids, [len(c) for c in chunks],
                                "whole-prompt prefill")
        longest = max(len(c) for c in chunks)
        T_pad = max(_MIN_TILE, 1 << (longest - 1).bit_length())
        group = max(1, self.PREFILL_BATCH_TOKENS // T_pad)
        if len(batch_uids) > group:
            results: Dict[int, np.ndarray] = {}
            for i in range(0, len(batch_uids), group):
                results.update(self._prefill_whole(
                    batch_uids[i:i + group], chunks[i:i + group]))
            return results
        descs = [self.state.schedule(uid, len(c))
                 for uid, c in zip(batch_uids, chunks)]
        B = len(descs)
        bpad = 1 << (B - 1).bit_length()
        ids = np.zeros((bpad, T_pad), np.int32)
        lengths = np.zeros((bpad,), np.int32)
        slots = np.zeros((bpad,), np.int32)
        for i, (d, c) in enumerate(zip(descs, chunks)):
            ids[i, :len(c)] = c
            lengths[i] = len(c)
            slots[i] = d.slot
        self._fence()
        t_host = time.perf_counter()
        logits = self._prefill_impl(self._t(ids), self._t(lengths),
                                    self._t(self._block_tables()),
                                    self._t(slots))
        t_disp = time.perf_counter()
        out = logits.float().cpu().numpy()
        self.timing = {
            "host_ms": (t_host - t_entry) * 1e3,
            "dispatch_ms": (t_disp - t_host) * 1e3,
            "fetch_ms": (time.perf_counter() - t_disp) * 1e3,
        }
        self._observe_put(chunks)
        results = {}
        for i, (d, c) in enumerate(zip(descs, chunks)):
            results[d.uid] = out[i]
            self._pos[d.slot] = d.seen_tokens + len(c)
            self._commit(d.uid, c)
        return results

    # ---- packed continuous-batching step ---------------------------------
    def _pack_atoms(self, descs, chunks):
        """The packed two-region atom layout shared by :meth:`put` and the
        speculative verify: decode rows (bucketed to a power of two >= 8),
        then one pow2-wide tile atom per longer chunk. Returns ``(tok_ids,
        tok_slot, tok_pos, valid, starts, dr, tile, no_past)``."""
        items = list(enumerate(zip(descs, chunks)))
        dec = [(i, d, c) for i, (d, c) in items if len(c) == 1]
        big = [(i, d, c) for i, (d, c) in items if len(c) > 1]
        n_dec = len(dec)
        dr = max(8, 1 << (n_dec - 1).bit_length()) if n_dec else 0
        if big:
            longest = max(len(c) for _, _, c in big)
            tile = max(_MIN_TILE, 1 << (longest - 1).bit_length())
            tpad = 1 << (len(big) - 1).bit_length()
        else:
            tile, tpad = self.module.MAX_ATOM, 0
        npad = dr + tpad * tile
        tok_ids = np.zeros((npad,), np.int32)
        tok_slot = np.zeros((npad,), np.int32)
        tok_pos = np.zeros((npad,), np.int32)
        valid = np.zeros((npad,), bool)
        starts = np.zeros((len(descs),), np.int32)
        off = 0
        for i, d, c in dec:
            tok_ids[off] = c[0]
            tok_slot[off] = d.slot
            tok_pos[off] = d.seen_tokens
            valid[off] = True
            starts[i] = off
            off += 1
        off = dr
        for i, d, c in big:
            tok_ids[off:off + len(c)] = c
            tok_slot[off:off + tile] = d.slot
            tok_pos[off:off + len(c)] = d.seen_tokens + np.arange(len(c))
            valid[off:off + len(c)] = True
            starts[i] = off
            off += tile
        # every chunk atom at position 0 (fresh prefill): no past to read
        no_past = all(d.seen_tokens == 0 for _, d, c in big)
        return tok_ids, tok_slot, tok_pos, valid, starts, dr, tile, no_past

    def _packed_step(self, descs, chunks, gather_idx):
        """One packed step over the scheduled chunks (after the promote
        fence). Returns fp32 numpy logits at ``gather_idx`` and the host
        clock after the fence and after the step's launches."""
        tok_ids, tok_slot, tok_pos, valid, starts, dr, tile, no_past = \
            self._pack_atoms(descs, chunks)
        self._fence()
        t_host = time.perf_counter()
        logits, self.cache = self.module.forward_with_packed_cache(
            self.params, self._t(tok_ids), self.cache,
            self._t(self._block_tables()), self._t(tok_slot),
            self._t(tok_pos), self._t(valid), self._t(gather_idx(starts)),
            dr, tile, no_past)
        t_disp = time.perf_counter()
        return logits.float().cpu().numpy(), t_host, t_disp

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[np.ndarray]) -> Dict[int, np.ndarray]:
        """Advance every listed sequence by its token chunk; returns the
        next-token logits per uid (fp32 numpy [V]). Chunks may be whole
        prompts, single decode tokens, or anything between. With the prefix
        cache, a fresh multi-token chunk first attaches its cached
        full-block prefix and only the suffix is prefilled."""
        bus = self._ebus
        if not bus.enabled:
            return self._put_impl(batch_uids, batch_tokens)
        # the span carries the uid list: request tracks join the engine's
        # steps by uid
        with bus.span("engine", "put", args={
                "uids": [int(u) for u in batch_uids],
                "tokens": int(sum(np.atleast_1d(np.asarray(t)).size
                                  for t in batch_tokens))}):
            return self._put_impl(batch_uids, batch_tokens)

    def _put_impl(self, batch_uids: Sequence[int],
                  batch_tokens: Sequence[np.ndarray]
                  ) -> Dict[int, np.ndarray]:
        if len(batch_uids) != len(batch_tokens):
            raise ValueError("one token chunk per uid")
        t_put = time.perf_counter()
        self.timing = {}        # never report a previous put's numbers
        chunks = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        if not self.packed:
            return self._put_dense_tile(batch_uids, chunks)
        if self.prefix_cache is not None \
                and any(len(c) > 1 and u not in self.state.sequences
                        for u, c in zip(batch_uids, chunks)) \
                and self.state.can_schedule_batch(
                    batch_uids, [len(c) for c in chunks]):
            # attach only when the batch fits cold: a put that raises
            # CapacityError must leave no state behind, and attaching only
            # lowers demand, so every later check in this call passes
            trimmed = []
            for uid, c in zip(batch_uids, chunks):
                n = (self.prefix_attach(uid, c)
                     if len(c) > 1 and uid not in self.state.sequences
                     else 0)
                trimmed.append(c[n:] if n else c)
            chunks = trimmed
        if chunks and all(len(c) > 1 for c in chunks) \
                and max(len(c) for c in chunks) <= self.module.PREFILL_MAX \
                and all(self._fresh(uid) for uid in batch_uids):
            return self._prefill_whole(batch_uids, chunks)
        # chunked prefill: prompts longer than one atom are fed in MAX_ATOM
        # slices over internal steps, after a JOINT capacity check of the
        # whole batch (a mid-prompt failure would leave sequences
        # half-prefilled)
        cap = self.module.MAX_ATOM
        if any(len(c) > cap for c in chunks) and \
                not self.state.can_schedule_batch(
                    batch_uids, [len(c) for c in chunks]):
            raise CapacityError(batch_uids, [len(c) for c in chunks],
                                "joint chunked prefill")
        while any(len(c) > cap for c in chunks):
            sel = [(u, c[:cap]) for u, c in zip(batch_uids, chunks)
                   if len(c) > cap]
            self.put([u for u, _ in sel], [c for _, c in sel])
            chunks = [c[cap:] if len(c) > cap else c for c in chunks]
            # rebase the host clock: the sub-puts ran their steps to the end
            t_put = time.perf_counter()
        if not self.state.can_schedule_batch(batch_uids,
                                             [len(c) for c in chunks]):
            raise CapacityError(batch_uids, [len(c) for c in chunks])
        descs = [self.state.schedule(uid, len(toks))
                 for uid, toks in zip(batch_uids, chunks)]

        def chunk_ends(starts):                      # chunk end -> next token
            gather_idx = np.zeros((self.state.max_sequences,), np.int32)
            for i, c in enumerate(chunks):
                gather_idx[i] = starts[i] + len(c) - 1
            return gather_idx

        out, t_host, t_disp = self._packed_step(descs, chunks, chunk_ends)
        # host batch building vs the step's launches vs the device step and
        # the logits to host (on the card the launches run ahead of the
        # device, so dispatch_ms is the host's launch time)
        self.timing = {
            "host_ms": (t_host - t_put) * 1e3,
            "dispatch_ms": (t_disp - t_host) * 1e3,
            "fetch_ms": (time.perf_counter() - t_disp) * 1e3,
        }
        self._observe_put(chunks)
        results: Dict[int, np.ndarray] = {}
        for i, (d, c) in enumerate(zip(descs, chunks)):
            results[d.uid] = out[i]
            self._pos[d.slot] = d.seen_tokens + len(c)
            self._commit(d.uid, c)
        return results

    # ---- dense-tile step (packed=False / paged=False) ---------------------
    def _put_dense_tile(self, batch_uids, chunks) -> Dict[int, np.ndarray]:
        """One ``[max_sequences, t_max]`` tile, every slot a row: scheduled
        slots get their chunk right-padded, the rest no-op lanes (the
        reference's :1991-2035). Unchunked: ``t_max`` is the step's longest
        chunk."""
        if not self.state.can_schedule_batch(batch_uids,
                                             [len(c) for c in chunks]):
            raise CapacityError(batch_uids, [len(c) for c in chunks])
        descs = [self.state.schedule(uid, len(toks))
                 for uid, toks in zip(batch_uids, chunks)]
        Bs = self.state.max_sequences
        t_max = max(len(c) for c in chunks)
        tile = np.zeros((Bs, t_max), np.int32)
        valid = np.zeros((Bs, t_max), bool)
        for d, c in zip(descs, chunks):
            tile[d.slot, :len(c)] = c
            valid[d.slot, :len(c)] = True
        # next-token logits at each chunk's true end, gathered on the device
        slots = self._t(np.array([d.slot for d in descs], np.int64))
        ends = self._t(np.array([len(c) - 1 for c in chunks], np.int64))
        if self.paged:
            logits, self.cache = self.module.forward_with_paged_cache(
                self.params, self._t(tile), self.cache,
                self._t(self._block_tables()), self._t(self._pos),
                self._t(valid))
            pos = self._pos
        else:             # k, v written in place; every row's pos + t_max
            logits, _ = self.module.forward_with_cache(
                self.params, self._t(tile), self.cache, self._t(valid))
            pos = self.cache["pos"].cpu().numpy().copy()
        out = logits[slots, ends].float().cpu().numpy()
        del logits
        results: Dict[int, np.ndarray] = {}
        for i, (d, c) in enumerate(zip(descs, chunks)):
            results[d.uid] = out[i]
            pos[d.slot] = d.seen_tokens + len(c)
            self._commit(d.uid, c)
        if not self.paged:        # idle rows keep their true positions
            self.cache["pos"] = self._t(pos)
        return results

    # ---- fused multi-step decode -----------------------------------------
    def _multi_decode(self, bt, slots, pos0, tok0, steps: int, valid,
                      temperature: float = 0.0, top_k: int = 0,
                      top_p: float = 1.0, generator=None):
        """``steps`` decode iterations, greedy or (``temperature > 0``)
        sampled by ``sample_token`` with ``generator``, with the pool
        READ-ONLY: new KV accumulates in a dense tail [L, B, steps, K, d]
        that attention reads as a third flash-decode segment, and one
        scatter per pool folds it in after the loop. Returns the tokens
        [steps, B] on the device."""
        cfg = self.cfg
        B = tok0.shape[0]
        L, K, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        cdt = torch_dtype(cfg.dtype)
        tail = {"k": torch.zeros(L, B, steps, K, hd, dtype=cdt,
                                 device=self.device),
                "v": torch.zeros(L, B, steps, K, hd, dtype=cdt,
                                 device=self.device)}
        out = torch.empty(steps, B, dtype=torch.int32, device=self.device)
        toks = tok0
        for t in range(steps):
            logits, tail = self.module.forward_decode_tail(
                self.params, toks, self.cache, tail, t, bt, slots, pos0,
                valid)
            if temperature > 0.0:
                toks = sample_token(logits, temperature, top_k, generator,
                                    top_p=top_p).to(torch.int32)
            else:
                toks = torch.argmax(logits, dim=-1).to(torch.int32)
            out[t] = toks
        slot2 = slots.repeat_interleave(steps)
        pos2 = (pos0[:, None] + torch.arange(steps, dtype=pos0.dtype,
                                             device=self.device)[None, :]
                ).reshape(-1)
        valid2 = valid.repeat_interleave(steps)
        cache_append(self.cache, tail["k"].reshape(L, B * steps, K, hd),
                     tail["v"].reshape(L, B * steps, K, hd), bt, slot2, pos2,
                     valid2)
        return out

    def decode_batch(self, batch_uids: Sequence[int],
                     batch_tokens: Sequence[int], steps: int,
                     temperature: float = 0.0, top_k: int = 0,
                     top_p: float = 1.0, seed: int = 0,
                     speculative: Optional[bool] = None
                     ) -> Dict[int, np.ndarray]:
        """Advance every listed sequence ``steps`` tokens from its
        ``batch_tokens`` entry: greedy at ``temperature=0``, else the v1
        engine's temperature / top-k / nucleus sampling with draws from a
        ``torch.Generator`` seeded with ``seed`` (the same seed gives the
        same tokens; the reference's JAX key draws others from the same
        distribution). Returns the generated tokens per uid ([steps] int32
        each). With speculative decoding on (the engine's
        ``speculative=``, overridable per call) greedy decode runs
        draft-verify rounds instead: the same tokens, fewer forward passes.
        Sampling always takes the fused loop."""
        spec = (self.spec_cfg.enabled if speculative is None
                else bool(speculative))
        bus = self._ebus
        if bus.enabled:
            with bus.span("engine", "decode_batch",
                          args={"uids": [int(u) for u in batch_uids],
                                "steps": int(steps), "spec": spec}):
                return self._decode_batch_dispatch(
                    batch_uids, batch_tokens, steps, temperature, top_k,
                    top_p, seed, spec)
        return self._decode_batch_dispatch(batch_uids, batch_tokens, steps,
                                           temperature, top_k, top_p, seed,
                                           spec)

    def _decode_batch_dispatch(self, batch_uids, batch_tokens, steps,
                               temperature, top_k, top_p, seed, spec):
        if spec and temperature == 0.0 and self._hist is not None:
            return self._decode_batch_spec(batch_uids, batch_tokens, steps)
        return self._decode_batch_scan(batch_uids, batch_tokens, steps,
                                       temperature, top_k, top_p, seed)

    def _decode_batch_scan(self, batch_uids, batch_tokens, steps: int,
                           temperature: float = 0.0, top_k: int = 0,
                           top_p: float = 1.0, seed: int = 0
                           ) -> Dict[int, np.ndarray]:
        """The fused decode loop (one fetch regardless of ``steps``)."""
        if not self.packed:
            raise ValueError("decode_batch needs the packed paged engine")
        if not self.state.can_schedule_batch(batch_uids,
                                             [steps] * len(batch_uids)):
            raise CapacityError(batch_uids, [steps] * len(batch_uids),
                                "decode_batch")
        descs = [self.state.schedule(uid, steps) for uid in batch_uids]
        B = len(descs)
        bpad = max(8, 1 << (B - 1).bit_length())
        slots = np.zeros((bpad,), np.int32)
        slots[:B] = [d.slot for d in descs]
        pos0 = np.zeros((bpad,), np.int32)
        pos0[:B] = self._pos[slots[:B]]
        tok0 = np.zeros((bpad,), np.int32)
        tok0[:B] = np.asarray(batch_tokens, np.int32).reshape(B)
        valid = np.arange(bpad) < B
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(int(seed))
        self._fence()
        t_disp = time.perf_counter()
        out = self._multi_decode(self._t(self._block_tables()),
                                 self._t(slots), self._t(pos0),
                                 self._t(tok0), steps, self._t(valid),
                                 float(temperature), int(top_k),
                                 float(top_p), gen)
        toks = out.cpu().numpy()                        # [steps, bpad]
        if self._obs is not None:
            self._obs["decode_dispatches"].inc(1.0)
            self._obs["decode_tokens"].inc(float(steps * B))
            self._obs["decode_fetch_ms"].observe(
                (time.perf_counter() - t_disp) * 1e3)
        for i, d in enumerate(descs):
            self._pos[d.slot] = d.seen_tokens + steps
            # fed tokens: the start token and all but the last output (the
            # last one's KV is not in the pool yet)
            fed = (np.concatenate([tok0[i:i + 1], toks[:-1, i]])
                   if self._hist is not None else ())
            self._commit(d.uid, fed)
        return {d.uid: toks[:, i] for i, d in enumerate(descs)}

    # ---- n-gram speculative decoding (draft + batched verify) ------------
    def _draft(self, uids: Sequence[int], tokens: Sequence[int],
               caps: Sequence[int]) -> list:
        """Per-uid drafts from each sequence's committed history plus the
        token about to be fed (prompt lookup)."""
        from deepspeed_tpu_torch.inference.speculative import ngram_draft

        drafts = []
        for uid, t, cap in zip(uids, tokens, caps):
            seq = self.state.sequences.get(uid)
            room = self.max_seq_len - (seq.seen_tokens if seq else 0) - 1
            k = min(int(self.spec_cfg.max_draft), int(cap), room)
            h = self._hist.get(uid)
            hist = (np.concatenate([h, [t]]) if h is not None and h.size
                    else np.asarray([t], np.int32))
            drafts.append(ngram_draft(hist, self.spec_cfg.ngram, k)
                          if k > 0 else hist[:0])
        return drafts

    def draft_tokens(self, batch_uids: Sequence[int],
                     batch_tokens: Sequence[int],
                     max_drafts: Optional[Sequence[int]] = None) -> list:
        """Host-side n-gram drafts per uid (possibly empty arrays)."""
        if self._hist is None:
            raise ValueError("draft_tokens needs speculative (or "
                             "prefix_cache) enabled on the engine")
        caps = (max_drafts if max_drafts is not None
                else [self.spec_cfg.max_draft] * len(batch_uids))
        return self._draft(batch_uids, batch_tokens, caps)

    def spec_decode_round(self, batch_uids: Sequence[int],
                          batch_tokens: Sequence[int],
                          max_drafts: Optional[Sequence[int]] = None,
                          drafts: Optional[list] = None):
        """One greedy draft-verify round for every listed sequence: draft
        (or take ``drafts``), verify all drafts in one packed step, accept
        the longest prefix the model confirms plus its own next token.
        Returns ``({uid: emitted int32 array (1..K+1 tokens)}, info)`` with
        the round's drafted / accepted / emitted counts."""
        if drafts is None:
            drafts = self.draft_tokens(batch_uids, batch_tokens, max_drafts)
        elif self._hist is None:
            raise ValueError("spec_decode_round needs speculative (or "
                             "prefix_cache) enabled on the engine")
        return self._spec_verify(batch_uids, batch_tokens, drafts)

    def _spec_verify(self, batch_uids, batch_tokens, drafts):
        bus = self._ebus
        if not bus.enabled:
            return self._spec_verify_impl(batch_uids, batch_tokens, drafts)
        with bus.span("engine", "spec_verify",
                      args={"uids": [int(u) for u in batch_uids],
                            "drafted": int(sum(len(d) for d in drafts))}):
            return self._spec_verify_impl(batch_uids, batch_tokens, drafts)

    def _spec_verify_impl(self, batch_uids, batch_tokens, drafts):
        """Verify per-sequence chunks ``[t0, d1..dk]`` in one packed step
        with logits gathered at every chunk position, then accept greedily.
        KV of rejected drafts lands in the pool past the frontier, which
        only advances over accepted tokens, so later steps overwrite those
        rows before any read reaches them."""
        chunks = [np.concatenate([[int(t)], np.asarray(d, np.int64)])
                  .astype(np.int32)
                  for t, d in zip(batch_tokens, drafts)]
        lens = [len(c) for c in chunks]
        if not self.state.can_schedule_batch(batch_uids, lens):
            raise CapacityError(batch_uids, lens, "spec verify round")
        descs = [self.state.schedule(uid, n)
                 for uid, n in zip(batch_uids, lens)]
        # logits at EVERY chunk position, chunk-major, padded to a power of
        # two >= 8
        G = sum(lens)
        goff = np.cumsum([0] + lens[:-1]).astype(np.int32)

        def every_position(starts):
            gidx = np.zeros((max(8, 1 << (G - 1).bit_length()),), np.int32)
            for i, c in enumerate(chunks):
                gidx[goff[i]:goff[i] + len(c)] = starts[i] + np.arange(len(c))
            return gidx

        out, _, _ = self._packed_step(descs, chunks,
                                      every_position)            # [gpad, V]
        results: Dict[int, np.ndarray] = {}
        info = {"drafted": int(G - len(descs)), "accepted": 0, "emitted": 0,
                "nonfinite_uids": []}
        for i, (d, c) in enumerate(zip(descs, chunks)):
            lg = out[goff[i]:goff[i] + len(c)]             # [len(c), V]
            if not np.all(np.isfinite(lg)):
                # argmax over NaN would emit token 0 silently: commit only
                # t0 (its KV is in the pool) and flag the uid
                d.in_flight = 1
                self._pos[d.slot] = d.seen_tokens + 1
                self._commit(d.uid, c[:1])
                results[d.uid] = np.asarray([int(np.argmax(lg[0]))],
                                            np.int32)
                info["nonfinite_uids"].append(d.uid)
                info["emitted"] += 1
                continue
            emitted = [int(np.argmax(lg[0]))]
            j = 1
            while j < len(c) and int(c[j]) == emitted[-1]:
                emitted.append(int(np.argmax(lg[j])))
                j += 1
            m = len(emitted)        # fed tokens confirmed in KV: c[:m]
            d.in_flight = m
            self._pos[d.slot] = d.seen_tokens + m
            self._commit(d.uid, c[:m])
            results[d.uid] = np.asarray(emitted, np.int32)
            info["accepted"] += m - 1
            info["emitted"] += m
        self.spec_stats["rounds"] += 1
        self.spec_stats["drafted"] += info["drafted"]
        self.spec_stats["accepted"] += info["accepted"]
        self.spec_stats["emitted"] += info["emitted"]
        return results, info

    def _decode_batch_spec(self, batch_uids, batch_tokens, steps: int
                           ) -> Dict[int, np.ndarray]:
        """Greedy decode by draft-verify rounds; a round where no sequence
        has a draft runs the fused loop for a power-of-two chunk of steps
        instead. Token-identical to the fused loop."""
        B = len(batch_uids)
        # the same demand as the fused loop: draft caps are remaining - 1,
        # so no round writes past seen + steps - 1
        if not self.state.can_schedule_batch(batch_uids, [steps] * B):
            raise CapacityError(batch_uids, [steps] * B, "decode_batch")
        out: Dict[int, list] = {u: [] for u in batch_uids}
        remaining = {u: steps for u in batch_uids}
        cur = {u: int(t) for u, t in zip(batch_uids, batch_tokens)}
        while True:
            live = [u for u in batch_uids if remaining[u] > 0]
            if not live:
                break
            caps = [remaining[u] - 1 for u in live]
            drafts = self._draft(live, [cur[u] for u in live], caps)
            if not any(len(d) for d in drafts):
                n = min(min(remaining[u] for u in live),
                        int(self.spec_cfg.fallback_steps))
                n = 1 << (n.bit_length() - 1)
                res = self._decode_batch_scan(live,
                                              [cur[u] for u in live], n)
                self.spec_stats["fallback_steps"] += n
                for u in live:
                    toks = [int(t) for t in res[u]]
                    out[u].extend(toks)
                    remaining[u] -= n
                    cur[u] = toks[-1]
                continue
            res, _ = self._spec_verify(live, [cur[u] for u in live], drafts)
            for u in live:
                toks = [int(t) for t in res[u]]
                out[u].extend(toks)
                remaining[u] -= len(toks)
                cur[u] = toks[-1]
        return {u: np.asarray(out[u], np.int32) for u in batch_uids}
