"""Analytic mesh cost model: predicted step time per (model, mesh shape)
(counterpart of ``deepspeed_tpu/parallel/cost_model.py``; pure host
arithmetic, no device).

A mesh shape (how the device count factors into the named axes
pp/dp/fsdp/ep/sp/tp) turns into predicted step time from first principles:

* **collective payloads** -- all-gather / reduce-scatter volumes over the
  fsdp axis (ZeRO wire bytes, quantized through :func:`wire_bytes`, the
  ZeRO++ wire arithmetic kept here), grad all-reduce over dp, per-layer
  activation collectives over tp/sp/ep, boundary sends over pp;
* **pipeline bubble** -- ``(pp-1)/(micro_batches + pp - 1)``;
* **link classes** -- bytes over an axis whose extent exceeds its
  fast-link domain (``ici_sizes``) are slow-link (DCN) bytes, the rest
  fast-link (ICI) bytes.

Rates are calibrated by :func:`fit_bandwidths` (least squares over measured
``bench_scaling`` ledger points) and default to round placeholders.
:func:`model_signature` names a model shape; the serving warm-start cache
and the mesh winner store key on it, and it is the same string as the
reference's for the same preset, so both packages name a model's caches
alike.
"""


from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

#: the named mesh axes in canonical order (the reference's
#: ``parallel/topology.py``)
MESH_AXES: Tuple[str, ...] = ("pp", "dp", "fsdp", "ep", "sp", "tp")

#: bytes on the wire per element for the bf16 collectives the volumes assume
_WIRE_ITEMSIZE = 2


@dataclasses.dataclass(frozen=True)
class ModelProfile:
    """The divisibility + payload facts the cost model needs from a model."""

    n_params: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    hidden: int
    vocab: int
    seq: int
    n_experts: int = 1
    top_k: int = 2
    # params touched per token (MoE: attn/embed + top_k of the expert MLPs)
    active_params: Optional[int] = None
    # the model can shard the sequence axis (ulysses / ring / fpdt attention)
    sp_capable: bool = False
    # MoE a2a dispatch wire format (comm/quantized.py moe_all_to_all):
    # 0 = dense bf16 tokens, 4/8 = blockwise-quantized payload
    moe_a2a_bits: int = 0
    moe_a2a_block: int = 2048

    @property
    def active(self) -> int:
        return self.active_params if self.active_params else self.n_params

    @classmethod
    def from_transformer_config(cls, cfg, seq: Optional[int] = None
                                ) -> "ModelProfile":
        """Profile a :class:`~deepspeed_tpu_torch.models.TransformerConfig`."""
        n = int(cfg.num_params_estimate())
        active = n
        if cfg.num_experts > 1:
            # num_params_estimate counts ONE dense MLP per layer; the MoE
            # model holds num_experts copies and routes each token through
            # top_k of them
            mlp = (3 if cfg.activation == "swiglu" else 2) \
                * cfg.hidden_size * cfg.intermediate_size
            k = min(cfg.top_k, cfg.num_experts)
            active = n + cfg.num_layers * (k - 1) * mlp
            n = n + cfg.num_layers * (cfg.num_experts - 1) * mlp
        return cls(
            n_params=n, n_layers=int(cfg.num_layers),
            n_heads=int(cfg.num_heads), n_kv_heads=int(cfg.num_kv_heads),
            hidden=int(cfg.hidden_size), vocab=int(cfg.vocab_size),
            seq=int(seq or cfg.max_seq_len), n_experts=int(cfg.num_experts),
            top_k=int(cfg.top_k), active_params=int(active),
            sp_capable=cfg.attention_impl in ("ulysses", "ring", "fpdt"),
            moe_a2a_bits=int(getattr(cfg, "moe_a2a_bits", 0) or 0),
            moe_a2a_block=int(getattr(cfg, "moe_a2a_block", 2048) or 2048))

    @classmethod
    def from_model(cls, model, seq: Optional[int] = None
                   ) -> Optional["ModelProfile"]:
        """Best-effort profile of an engine model (``.cfg`` duck-typed);
        None when the model is not introspectable."""
        cfg = getattr(model, "cfg", None)
        if cfg is None or not hasattr(cfg, "num_params_estimate"):
            return None
        try:
            return cls.from_transformer_config(cfg, seq=seq)
        except Exception:
            return None


def model_signature(profile: ModelProfile) -> str:
    """Stable winner-cache key for a model shape (layout facts only — two
    models with the same signature shard identically)."""
    return (f"p{profile.n_params}-l{profile.n_layers}-h{profile.n_heads}"
            f"-kv{profile.n_kv_heads}-d{profile.hidden}-v{profile.vocab}"
            f"-e{profile.n_experts}-s{profile.seq}")


# ---------------------------------------------------------------------------
# mesh enumeration
# ---------------------------------------------------------------------------

def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def axis_legal(axis: str, size: int, profile: ModelProfile) -> bool:
    """Model-divisibility pruning for one mesh axis assignment."""
    if size == 1:
        return True
    if axis == "tp":
        return (profile.n_heads % size == 0
                and profile.n_kv_heads % size == 0
                and profile.hidden % size == 0)
    if axis == "pp":
        return profile.n_layers % size == 0 and size <= profile.n_layers
    if axis == "ep":
        return profile.n_experts > 1 and profile.n_experts % size == 0
    if axis == "sp":
        return (profile.sp_capable and profile.seq % size == 0
                and profile.n_heads % size == 0
                and profile.n_kv_heads % size == 0)
    return True  # dp / fsdp shard the batch / params freely


def enumerate_meshes(world: int, profile: ModelProfile,
                     axes: Sequence[str] = MESH_AXES,
                     max_axis: Optional[Dict[str, int]] = None
                     ) -> List[Dict[str, int]]:
    """Every legal factorization of ``world`` over ``axes``.

    Legal = the axis sizes multiply to exactly ``world`` and every axis
    passes :func:`axis_legal` (heads % tp, layers % pp, experts % ep, seq %
    sp, ...). Returned dicts carry only the axes > 1 (``{}`` is the 1-device
    mesh) in deterministic order: sorted by the size tuple in canonical
    ``MESH_AXES`` order, so two runs (or two hosts) always agree on
    candidate numbering.
    """
    axes = [ax for ax in MESH_AXES if ax in axes]  # canonical order
    max_axis = max_axis or {}
    out: List[Dict[str, int]] = []

    def rec(i: int, remaining: int, acc: Dict[str, int]) -> None:
        if i == len(axes):
            if remaining == 1:
                out.append(dict(acc))
            return
        ax = axes[i]
        for d in _divisors(remaining):
            if d > max_axis.get(ax, remaining):
                continue
            if not axis_legal(ax, d, profile):
                continue
            if d > 1:
                acc[ax] = d
            rec(i + 1, remaining // d, acc)
            acc.pop(ax, None)

    rec(0, int(world), {})
    out.sort(key=lambda m: tuple(m.get(ax, 1) for ax in MESH_AXES))
    return out


# ---------------------------------------------------------------------------
# quantized wire arithmetic (the reference's ``comm/quantized.py``)
# ---------------------------------------------------------------------------

def effective_group_size(n: int, block_size: int) -> int:
    """The quant-group size blockwise quantization uses for an
    ``n``-element tensor (halved until it divides ``n``)."""
    gs = min(int(block_size), int(n))
    while n % gs != 0:
        gs //= 2
    return gs


def effective_bits(n: int, bits: int, block_size: int) -> int:
    """int4 packs two nibbles a byte, which needs an even quant group;
    odd-geometry tensors fall back to int8."""
    if bits == 4 and effective_group_size(n, block_size) % 2 != 0:
        return 8
    return bits


def wire_bytes(n: int, bits: int, block_size: int) -> int:
    """Analytic wire payload of one quantized tensor: packed int payload
    plus one fp32 scale per quant group."""
    bits = effective_bits(n, bits, block_size)
    gs = effective_group_size(n, block_size)
    groups = n // gs
    payload = groups * (gs // 2 if bits == 4 else gs)
    return payload + groups * 4


# ---------------------------------------------------------------------------
# payload math
# ---------------------------------------------------------------------------

def quantized_wire_ratio(n_elems: int, bits: int, block_size: int) -> float:
    """Quantized wire bytes over the bf16 dense payload for an
    ``n_elems``-element tensor (same arithmetic as the ZeRO++ wire layer)."""
    n = max(int(n_elems), 1)
    return wire_bytes(n, bits, block_size) / float(n * _WIRE_ITEMSIZE)


def moe_a2a_bytes(tok_chip: float, hidden: int, top_k: int, ep: int, *,
                  itemsize: int = _WIRE_ITEMSIZE, quant_bits: int = 0,
                  block_size: int = 2048, ici_size: Optional[int] = None,
                  two_hop: bool = True) -> Dict[str, float]:
    """Per-chip, per-layer MoE a2a wire bytes by link class (dispatch +
    combine of the ``top_k``-routed tokens over the ``ep`` axis).

    Mirrors ``comm.quantized.moe_all_to_all``: when the ep axis fits one
    ICI domain (``ici_size`` absent or >= ep) the whole payload is a
    single-hop a2a — ``2 * (ep-1)/ep * tok_chip * top_k * hidden *
    itemsize`` scaled by the quantized wire ratio when ``quant_bits`` is
    set (identical to the pre-a2a-aware ``per_axis['ep']`` formula at
    bits=0). When the axis spans DCN (``ici_size`` < ep) the default is
    the hierarchical two-hop path: only the cross-slice fraction
    ``(m-1)/m`` (``m = ep/ici_size`` slices) crosses DCN — quantized —
    while the ``(s-1)/s`` intra-slice hop stays dense on ICI. That split
    is what lets :func:`enumerate_meshes` + :meth:`CostModel.rank` prefer
    DCN-spanning ep shapes over DCN-spanning tp/sp ones on multi-slice
    topologies instead of guessing.
    """
    elems = float(tok_chip) * int(top_k) * int(hidden)
    dense = elems * itemsize
    r = (quantized_wire_ratio(max(int(elems), 1), quant_bits, block_size)
         if quant_bits else 1.0)
    s = ep if ici_size is None else max(1, min(int(ici_size), ep))
    if s >= ep:
        ici, dcn = 2 * dense * (ep - 1) / ep * r, 0.0
    elif not two_hop or s <= 1:
        ici, dcn = 0.0, 2 * dense * (ep - 1) / ep * r
    else:
        m = max(ep // s, 1)
        dcn = 2 * dense * (m - 1) / m * r
        ici = 2 * dense * (s - 1) / s
    return {"ici": ici, "dcn": dcn, "total": ici + dcn}


def collective_volumes(profile: ModelProfile, mesh: Dict[str, int], *,
                       zero_stage: int = 0,
                       zero_pp: Optional[Dict[str, Any]] = None,
                       tokens: Optional[int] = None,
                       micro_batches: int = 1,
                       ici_sizes: Optional[Dict[str, int]] = None
                       ) -> Dict[str, Any]:
    """Per-chip, per-step analytic volume breakdown for one mesh shape.

    Returns ``flops`` (per-chip compute work), ``ici_bytes`` / ``dcn_bytes``
    (per-chip wire bytes by link class), ``bubble_frac`` (pipeline fill/
    drain), and the ``per_axis`` byte attribution the drills print. These
    are the regressors :func:`fit_bandwidths` calibrates against measured
    step times — keep them cheap and deterministic (pure host math).
    """
    g = {ax: int(mesh.get(ax, 1)) for ax in MESH_AXES}
    d, f, t, p, e, s = (g["dp"], g["fsdp"], g["tp"], g["pp"], g["ep"],
                        g["sp"])
    world = d * f * t * p * e * s
    tokens = int(tokens or profile.seq)
    zpp = zero_pp or {}

    # compute: dense-equivalent flops split evenly over the mesh (the
    # pipeline bubble is accounted separately as idle-fraction, not flops)
    flops_per_token = (6 * profile.active
                       + 12 * profile.n_layers * profile.seq * profile.hidden)
    flops = flops_per_token * tokens / world

    n_stage = profile.n_params / p          # params resident per pp stage
    act = _WIRE_ITEMSIZE                    # bf16 activations on the wire
    # tokens a single chip's layer stack processes per step: batch is
    # sharded over dp*fsdp, sequence over sp; every microbatch crosses
    # every pp stage, and the tp group shares its tokens
    tok_chip = tokens / (d * f * s)

    wr = gr = 1.0                           # quantized wire ratios (qwZ/qgZ)
    if zpp.get("enabled") and zpp.get("qwz"):
        wr = quantized_wire_ratio(int(n_stage), int(zpp.get("weight_bits", 8)),
                                  int(zpp.get("block_size", 2048)))
    if zpp.get("enabled") and zpp.get("qgz"):
        gr = quantized_wire_ratio(int(n_stage), int(zpp.get("grad_bits", 8)),
                                  int(zpp.get("block_size", 2048)))

    per_axis: Dict[str, float] = {}
    if f > 1:
        shard_frac = (f - 1) / f
        rs = n_stage * _WIRE_ITEMSIZE * shard_frac * gr   # grad scatter
        ag = (n_stage * _WIRE_ITEMSIZE * shard_frac * wr
              if zero_stage >= 3 else 0.0)                # param gather
        per_axis["fsdp"] = rs + ag
    if d > 1:
        # all-reduce of the (fsdp-sharded) grad shard over pure dp
        per_axis["dp"] = 2 * (n_stage / f) * _WIRE_ITEMSIZE * (d - 1) / d
    if t > 1:
        # 2 activation all-reduces per layer (attn out + mlp out)
        per_axis["tp"] = (profile.n_layers / p) * 2 * (2 * (t - 1) / t) \
            * tok_chip * profile.hidden * act
    if s > 1:
        # Ulysses: 4 all-to-alls per layer over the sequence axis
        per_axis["sp"] = (profile.n_layers / p) * 4 * ((s - 1) / s) \
            * tok_chip * profile.hidden * act
    ep_split = None
    if e > 1:
        # dispatch + combine all-to-alls of top_k-routed tokens per layer
        # (moe_a2a_bytes knows the quantized / hierarchical two-hop wire,
        # so a DCN-spanning ep axis pays only its cross-slice fraction)
        per_layer = moe_a2a_bytes(
            tok_chip, profile.hidden, profile.top_k, e, itemsize=act,
            quant_bits=profile.moe_a2a_bits,
            block_size=profile.moe_a2a_block,
            ici_size=None if ici_sizes is None else ici_sizes.get("ep"))
        scale = profile.n_layers / p
        ep_split = {"ici": per_layer["ici"] * scale,
                    "dcn": per_layer["dcn"] * scale}
        per_axis["ep"] = per_layer["total"] * scale
    if p > 1:
        # boundary activation p2p, forward + backward
        per_axis["pp"] = 2 * tok_chip * profile.hidden * act

    def link(ax: str) -> str:
        size = g[ax]
        if ici_sizes is not None and ici_sizes.get(ax, size) < size:
            return "dcn"
        return "ici"

    ici = sum(v for ax, v in per_axis.items()
              if ax != "ep" and link(ax) == "ici")
    dcn = sum(v for ax, v in per_axis.items()
              if ax != "ep" and link(ax) == "dcn")
    if ep_split is not None:
        ici += ep_split["ici"]
        dcn += ep_split["dcn"]
    m = max(int(micro_batches), 1)
    bubble = (p - 1) / (m + p - 1) if p > 1 else 0.0
    return {"flops": flops, "ici_bytes": ici, "dcn_bytes": dcn,
            "bubble_frac": bubble, "per_axis": per_axis, "world": world}


# ---------------------------------------------------------------------------
# the calibrated model
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LinkBandwidths:
    """Sustained rates the predictor divides volumes by. The defaults are
    deliberately round placeholders — real numbers come from
    :func:`fit_bandwidths` over measured ledger curves."""

    flops_per_s: float = 1e12
    ici_bytes_per_s: float = 4e10
    dcn_bytes_per_s: float = 2.5e9
    overhead_s: float = 0.0
    calibrated_from: int = 0       # measured points behind the fit (0=default)

    def as_dict(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


class CostModel:
    """Predicted step time per mesh shape, with ledger-calibrated rates."""

    def __init__(self, bandwidths: Optional[LinkBandwidths] = None):
        self.bw = bandwidths or LinkBandwidths()

    def predict(self, profile: ModelProfile, mesh: Dict[str, int], *,
                zero_stage: int = 0,
                zero_pp: Optional[Dict[str, Any]] = None,
                tokens: Optional[int] = None, micro_batches: int = 1,
                ici_sizes: Optional[Dict[str, int]] = None
                ) -> Dict[str, Any]:
        """Predicted step seconds + the volume breakdown it came from."""
        vol = collective_volumes(
            profile, mesh, zero_stage=zero_stage, zero_pp=zero_pp,
            tokens=tokens, micro_batches=micro_batches, ici_sizes=ici_sizes)
        busy = (vol["flops"] / self.bw.flops_per_s
                + vol["ici_bytes"] / self.bw.ici_bytes_per_s
                + vol["dcn_bytes"] / self.bw.dcn_bytes_per_s
                + self.bw.overhead_s)
        total = busy / max(1e-9, 1.0 - vol["bubble_frac"])
        return {"step_s": total, **vol}

    def rank(self, profile: ModelProfile, candidates: Sequence[Dict[str, int]],
             **kw) -> List[Tuple[Dict[str, int], float]]:
        """Candidates ordered fastest-predicted-first (stable: ties keep the
        deterministic enumeration order)."""
        scored = [(m, self.predict(profile, m, **kw)["step_s"])
                  for m in candidates]
        return sorted(scored, key=lambda ms: ms[1])


    def predict_throughput(self, profile: ModelProfile,
                           mesh: Dict[str, int], *, micro_batch: int = 1,
                           seq: Optional[int] = None, **kw) -> Dict[str, Any]:
        """Predicted tokens/s under the harness batch law: every data-
        parallel rank (dp × fsdp) carries ``micro_batch`` sequences, so the
        global tokens/step — and with it how well fixed overhead and comm
        amortize — varies per shape. Ranking by raw step time would make a
        1-token tp-only mesh look "fastest"; throughput is the comparable
        number."""
        seq = int(seq or profile.seq)
        dpw = int(mesh.get("dp", 1)) * int(mesh.get("fsdp", 1))
        tokens = int(micro_batch) * dpw * seq
        pred = self.predict(profile, mesh, tokens=tokens, **kw)
        pred["tokens_per_step"] = tokens
        pred["tokens_per_sec"] = tokens / max(pred["step_s"], 1e-12)
        return pred

    def rank_by_throughput(self, profile: ModelProfile,
                           candidates: Sequence[Dict[str, int]],
                           **kw) -> List[Tuple[Dict[str, int], float]]:
        """Candidates ordered highest-predicted-tokens/s first (stable)."""
        scored = [(m, self.predict_throughput(profile, m,
                                              **kw)["tokens_per_sec"])
                  for m in candidates]
        return sorted(scored, key=lambda ms: -ms[1])


def rank_meshes(profile: ModelProfile, world: int,
                cost_model: Optional[CostModel] = None,
                candidates: Optional[Sequence[Dict[str, int]]] = None,
                **kw) -> List[Tuple[Dict[str, int], float]]:
    """Enumerate (or take) candidates and order them by predicted step time."""
    cm = cost_model or CostModel()
    cands = (list(candidates) if candidates is not None
             else enumerate_meshes(world, profile))
    return cm.rank(profile, cands, **kw)


# ---------------------------------------------------------------------------
# calibration from measured curves
# ---------------------------------------------------------------------------

def fit_bandwidths(samples: Sequence[Dict[str, Any]],
                   base: Optional[LinkBandwidths] = None) -> LinkBandwidths:
    """Least-squares calibration of (flops, ICI, DCN, overhead) from
    measured points.

    Each sample carries a measured ``step_s`` next to its analytic volumes
    (``flops``, ``ici_bytes``, ``dcn_bytes``, ``bubble_frac`` — the
    :func:`collective_volumes` output the scaling harness records per curve
    point). The busy-time model is linear in the inverse rates::

        step_s * (1 - bubble) = flops/R_f + ici/R_i + dcn/R_d + overhead

    so one ``lstsq`` recovers them. Regressors that never vary (e.g. no DCN
    bytes on a single-slice harness) keep their prior value instead of
    fitting noise; non-physical (<= 0) coefficients likewise fall back to
    the prior — calibration must degrade gracefully on thin data, never
    produce a negative bandwidth.
    """
    base = base or LinkBandwidths()
    pts = [s for s in samples
           if s.get("step_s") and np.isfinite(s["step_s"])]
    if len(pts) < 2:
        return base

    cols = ["flops", "ici_bytes", "dcn_bytes"]
    active = [c for c in cols if any(float(s.get(c, 0.0)) > 0 for s in pts)]
    A = np.array([[float(s.get(c, 0.0)) for c in active] + [1.0]
                  for s in pts])
    y = np.array([float(s["step_s"])
                  * (1.0 - float(s.get("bubble_frac", 0.0))) for s in pts])
    try:
        x, *_ = np.linalg.lstsq(A, y, rcond=None)
    except np.linalg.LinAlgError:
        return base

    inv = dict(zip(active, x[:-1]))
    overhead = float(max(x[-1], 0.0))

    def rate(col: str, prior: float) -> float:
        v = inv.get(col)
        if v is None or not np.isfinite(v) or v <= 0:
            return prior
        return 1.0 / v

    return LinkBandwidths(
        flops_per_s=rate("flops", base.flops_per_s),
        ici_bytes_per_s=rate("ici_bytes", base.ici_bytes_per_s),
        dcn_bytes_per_s=rate("dcn_bytes", base.dcn_bytes_per_s),
        overhead_s=overhead, calibrated_from=len(pts))


def samples_from_ledger(entries: Sequence[Dict[str, Any]],
                        device: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """Flatten ``bench_scaling`` ledger entries into calibration samples —
    every curve point AND 1-chip baseline that recorded both a measured
    step time and its analytic volume breakdown (the zero-comm baselines
    anchor the flops/overhead separation; dropping them would fit a more
    collinear system than the sweep's own recorded calibration).

    ``device`` restricts to entries measured on that device kind — fitting
    one rate set across CPU-harness and TPU entries (orders of magnitude
    apart) would produce bandwidths meaningful for neither."""

    def walk(node):
        # curves nest device → shape → world → point; tolerate any depth
        if not isinstance(node, dict):
            return
        if "predicted" in node and "step_ms" in node:
            yield node
            return
        for v in node.values():
            yield from walk(v)

    out: List[Dict[str, Any]] = []
    for e in entries:
        if e.get("bench") != "bench_scaling":
            continue
        result = e.get("result") or {}
        if device is not None and result.get("device") not in (None, device):
            continue
        for section in ("curves", "baselines"):
            for pt in walk(result.get(section) or {}):
                pred = pt.get("predicted") or {}
                if pt.get("step_ms") and pred.get("flops"):
                    out.append({"step_s": float(pt["step_ms"]) / 1e3,
                                **pred})
    return out


def _read_scaling_ledger(path: Optional[str]) -> List[Dict[str, Any]]:
    """Minimal JSONL ledger reader (schema-1 entries, corrupt lines
    skipped); the default path is the repo's ``tools/bench_ledger.jsonl``
    (or ``DSTPU_BENCH_LEDGER_PATH``)."""
    import json
    import os

    if path is None:
        path = os.environ.get("DSTPU_BENCH_LEDGER_PATH") or os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "tools", "bench_ledger.jsonl")
    out: List[Dict[str, Any]] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(entry, dict) and entry.get("schema") == 1:
                    out.append(entry)
    except OSError:
        pass
    return out


def calibrated_cost_model(ledger_path: Optional[str] = None,
                          device: Optional[str] = None) -> CostModel:
    """A :class:`CostModel` whose rates are fitted from the bench ledger's
    ``bench_scaling`` curves measured on THIS device kind when any exist;
    default rates otherwise (the ``calibrated_from`` field says which you
    got)."""
    if device is None:
        try:
            # lazy: mesh_store imports this module at load time
            from deepspeed_tpu_torch.autotuning.mesh_store import device_kind

            device = device_kind()
        except Exception:
            device = None       # no backend yet → fit over everything
    samples = samples_from_ledger(_read_scaling_ledger(ledger_path),
                                  device=device)
    return CostModel(fit_bandwidths(samples))
