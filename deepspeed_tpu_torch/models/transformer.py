"""Decoder-only transformer LM family in PyTorch (counterpart of
``deepspeed_tpu/models/transformer.py``; the dense GPT-2/Llama family and
the serving entry points of the engines, over the paged pool or a dense
cache).

Parameters are a plain nested dict of tensors with the JAX package's tree
and orientation: per-layer weights STACKED on a leading layer axis
(``layers.attn.wq [L, D, H*hd]``, ...) and every matmul weight stored
``[Din, Dout]`` so a layer computes ``x @ w``. Layers run as a Python loop
over per-layer views of the stacks (:func:`_unstack`). Norms, rope and
softmax statistics are computed in fp32 and cast back, as the reference
does.

The training forward (:meth:`TransformerLM.loss_fn`) casts fp32 master
leaves to the compute dtype inside the forward, so autograd lands the
gradients in fp32, and wraps each layer in the ``remat_policy``'s
activation checkpointing.

Not ported yet (they raise ``NotImplementedError``): MoE layers,
``act_quant_bits``, the fpdt/ring/ulysses attention impls, random-LTD,
progressive layer drop and the tiled loss (``loss_tiling > 1``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The reference's config, field for field (so presets and overrides
    carry over); fields of features not ported yet are accepted and rejected
    where they would take effect."""

    vocab_size: int = 32000
    hidden_size: int = 512
    num_layers: int = 4
    num_heads: int = 8
    num_kv_heads: Optional[int] = None
    intermediate_size: Optional[int] = None
    max_seq_len: int = 1024

    arch: str = "llama"
    norm: Optional[str] = None
    activation: Optional[str] = None
    use_rope: Optional[bool] = None
    learned_pos: Optional[bool] = None
    tie_embeddings: bool = True
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    proj_bias: bool = False
    parallel_block: bool = False
    parallel_shared_norm: bool = False
    rope_pct: float = 1.0
    sliding_window: Optional[int] = None
    window_start_layer: int = 0
    rope_scaling: Optional[Dict[str, Any]] = None
    norm_eps: float = 1e-5

    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat_policy: str = "none"
    scan_layers: bool = True
    attention_impl: str = "auto"
    fpdt_chunk: Optional[int] = None
    act_quant_bits: Optional[int] = None
    z_loss: float = 0.0
    loss_tiling: int = 0

    num_experts: int = 1
    top_k: int = 2
    capacity_factor: float = 1.25
    moe_aux_loss_coef: float = 0.01
    moe_dispatch: str = "capacity"
    moe_ep_capacity_factor: float = 0.0
    moe_kernel: str = "ragged"
    moe_a2a_bits: int = 0
    moe_a2a_slice: int = 0
    moe_a2a_block: int = 512

    head_dim_override: Optional[int] = None

    def __post_init__(self):
        is_llama = self.arch == "llama"
        object.__setattr__(self, "norm", self.norm or ("rmsnorm" if is_llama else "layernorm"))
        object.__setattr__(self, "activation",
                           self.activation or ("swiglu" if is_llama else "gelu"))
        if self.use_rope is None:
            object.__setattr__(self, "use_rope", is_llama)
        if self.learned_pos is None:
            object.__setattr__(self, "learned_pos", not is_llama)
        if self.num_kv_heads is None:
            object.__setattr__(self, "num_kv_heads", self.num_heads)
        if self.intermediate_size is None:
            inter = (int(8 * self.hidden_size / 3) if self.activation == "swiglu"
                     else 4 * self.hidden_size)
            inter = max(128, ((inter + 127) // 128) * 128)
            object.__setattr__(self, "intermediate_size", inter)
        if self.head_dim_override is None and self.hidden_size % self.num_heads:
            raise ValueError("hidden_size must divide over num_heads")
        if self.num_heads % self.num_kv_heads:
            raise ValueError("num_heads must divide over num_kv_heads")
        if self.parallel_shared_norm and not self.parallel_block:
            raise ValueError("shared norm requires parallel_block")

    @property
    def head_dim(self) -> int:
        return self.head_dim_override or self.hidden_size // self.num_heads

    @property
    def rope_dim(self) -> int:
        return 2 * (int(self.head_dim * self.rope_pct) // 2)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def repeat_kv(k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """GQA: query head h reads kv head h // (H/K) (``repeat_interleave``
    over the head axis of [B, S, K, d])."""
    K = k.shape[2]
    if K != num_heads:
        rep = num_heads // K
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    return k, v


def xla_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None
                  ) -> torch.Tensor:
    """The reference's plain attention: q [B,T,H,d], k/v [B,S,K,d] ->
    [B,T,H,d]; scores in the input dtype, softmax in fp32, end-aligned
    causal mask (row t sees columns <= t + S - T). A parity oracle for
    tests: no model path calls it."""
    B, T, H, d = q.shape
    S = k.shape[1]
    k, v = repeat_kv(k, v, H)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(d)
    tpos = torch.arange(T, device=q.device)[:, None] + (S - T)
    col = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones(T, S, dtype=torch.bool, device=q.device)
    if causal:
        mask &= col <= tpos
    if window is not None:
        mask &= col > tpos - window
    scores = torch.where(mask, scores, torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _norm(x: torch.Tensor, w: Params, kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        xf = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
        out = xf * w["scale"].float()
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        out = (xf - mu) * torch.rsqrt(var + eps) * w["scale"].float() \
            + w["bias"].float()
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, max_seq: int, theta: float,
                     scaling: Optional[Dict[str, Any]] = None,
                     device=None) -> torch.Tensor:
    """[max_seq, head_dim//2] fp32 rotary angles, with HF linear / llama3
    frequency scaling."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    if scaling:
        rt = scaling.get("rope_type", scaling.get("type", "linear"))
        if rt == "linear":
            inv = inv / float(scaling["factor"])
        elif rt == "llama3":
            factor = float(scaling["factor"])
            lo = float(scaling.get("low_freq_factor", 1.0))
            hi = float(scaling.get("high_freq_factor", 4.0))
            orig = float(scaling.get("original_max_position_embeddings", 8192))
            wavelen = 2.0 * math.pi / inv
            smooth = (orig / wavelen - lo) / (hi - lo)
            interp = (1 - smooth) * inv / factor + smooth * inv
            inv = torch.where(wavelen > orig / lo, inv / factor,
                              torch.where(wavelen < orig / hi, inv, interp))
        else:
            raise ValueError(f"unsupported rope_scaling type '{rt}' "
                             "(have: linear, llama3)")
    t = torch.arange(max_seq, dtype=torch.float32, device=device)
    return torch.outer(t, inv)


def apply_rope(x: torch.Tensor, freqs: torch.Tensor,
               positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, H, d]; freqs [max_seq, rd//2]; positions [B, T] (default
    arange). Only the leading ``rd`` dims rotate (partial rotary)."""
    T = x.shape[1]
    rd = 2 * freqs.shape[-1]
    tail = None
    if rd < x.shape[-1]:
        x, tail = x[..., :rd], x[..., rd:]
    f = (freqs[:T][None, :, None, :] if positions is None
         else freqs[positions.long()][:, :, None, :])
    cos, sin = torch.cos(f), torch.sin(f)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                    dim=-1).to(x.dtype)
    return out if tail is None else torch.cat([out, tail], dim=-1)


class QuantizedWeight:
    """Packed int8/int4 matmul weight standing where a dense ``[Din, F]``
    leaf (or a stacked ``[L, Din, F]`` one) sits in the parameter tree
    (``ops/quant_matmul.py`` layout): ``packed`` int8, ``scales``
    ``[.., Din/group, F]`` in the compute dtype, ``bits`` 4 or 8, ``din``
    the contraction width. :func:`linear` sends it to kernel G (one matrix)
    or, through a :class:`QuantLayerRef`, kernel H (a stacked leaf)."""

    __slots__ = ("packed", "scales", "bits", "din")

    def __init__(self, packed: torch.Tensor, scales: torch.Tensor, bits: int,
                 din: int):
        self.packed, self.scales = packed, scales
        self.bits, self.din = int(bits), int(din)

    @property
    def nbytes(self) -> int:
        return (self.packed.numel() * self.packed.element_size()
                + self.scales.numel() * self.scales.element_size())


def split_quant_leaves(layers: Params):
    """A stacked layer tree as (its dense leaves, ``[(group, name, stacked
    QuantizedWeight)]``)."""
    dense, quant = {}, []
    for grp, sub in layers.items():
        dense[grp] = {}
        for name, leaf in sub.items():
            if isinstance(leaf, QuantizedWeight):
                quant.append((grp, name, leaf))
            else:
                dense[grp][name] = leaf
    return dense, quant


class QuantLayerRef(NamedTuple):
    """Layer ``layer`` of a stacked :class:`QuantizedWeight`: :func:`linear`
    runs kernel H over the whole stack with the layer picked inside, so no
    per-layer slice of the packed weights is ever made."""

    qw: QuantizedWeight
    layer: int


def linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x [..., Din] @ w`` for a dense ``[Din, Dout]`` tensor, a
    :class:`QuantizedWeight` (kernel G) or a :class:`QuantLayerRef`
    (kernel H)."""
    if isinstance(w, (QuantizedWeight, QuantLayerRef)):
        from deepspeed_tpu_torch.ops import quant_matmul as qm

        qw, layer = (w.qw, w.layer) if isinstance(w, QuantLayerRef) else \
            (w, None)
        lead = x.shape[:-1]
        out = qm.quantized_matmul(x.reshape(-1, qw.din).contiguous(),
                                  qw.packed, qw.scales, bits=qw.bits,
                                  layer=layer)
        return out.reshape(*lead, out.shape[-1])
    return x @ w


def qkv_proj(x: torch.Tensor, w: Params, cfg: TransformerConfig):
    """q/k/v projections (+ optional biases); serving engines may install a
    fused ``wqkv [D, (H+2K)*hd]`` leaf (one product instead of three)."""
    B, T = x.shape[0], x.shape[1]
    hd, H, K = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    if "wqkv" in w:
        qkv = linear(x, w["wqkv"])
        if "bqkv" in w:
            qkv = qkv + w["bqkv"]
        # the kernels take contiguous q/k/v, not views of the fused product
        q, k, v = (t.contiguous() for t in
                   torch.split(qkv, [H * hd, K * hd, K * hd], dim=-1))
    else:
        q, k, v = linear(x, w["wq"]), linear(x, w["wk"]), linear(x, w["wv"])
        if "bq" in w:
            q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    return (q.reshape(B, T, H, hd), k.reshape(B, T, K, hd),
            v.reshape(B, T, K, hd))


def attn_out_proj(attn: torch.Tensor, w: Params, cfg: TransformerConfig
                  ) -> torch.Tensor:
    B, T = attn.shape[0], attn.shape[1]
    o = linear(attn.reshape(B, T, cfg.num_heads * cfg.head_dim), w["wo"])
    return o + w["bo"] if "bo" in w else o


_ACTS = {"gelu": lambda h: F.gelu(h, approximate="tanh"),
         "gelu_exact": F.gelu, "relu": F.relu}


def mlp_block(x: torch.Tensor, w: Params, cfg: TransformerConfig
              ) -> torch.Tensor:
    if cfg.act_quant_bits:
        raise NotImplementedError("act_quant_bits is not ported yet")
    if cfg.activation == "swiglu":
        if "w_gateup" in w:              # serving-fused gate|up
            g, u = linear(x, w["w_gateup"]).chunk(2, dim=-1)
            h = F.silu(g) * u
        else:
            h = F.silu(linear(x, w["w_gate"])) * linear(x, w["w_up"])
    else:
        up = linear(x, w["w_up"])
        h = _ACTS[cfg.activation](up + w["b_up"] if "b_up" in w else up)
    out = linear(h, w["w_down"])
    return out + w["b_down"] if "b_down" in w else out


def _cached_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid: torch.Tensor) -> torch.Tensor:
    """Attention over a padded dense KV cache (the reference's :455, which
    XLA computes: plain torch here too). q [B, t, H, d], k/v [B, S, K, d],
    ``valid`` [B, t, S] bool per query row. Scores in q's dtype, masked with
    its ``finfo.min``, softmax in fp32, probabilities cast to q's dtype
    before the PV product."""
    k, v = repeat_kv(k, v, q.shape[2])
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(q.shape[-1])
    scores = torch.where(valid[:, None], scores,
                         torch.finfo(scores.dtype).min)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def _decode_block(h: torch.Tensor, wc: Params, cfg: TransformerConfig,
                  freqs: Optional[torch.Tensor],
                  positions: Optional[torch.Tensor],
                  attn_cache_fn: Callable) -> torch.Tensor:
    """One pre-norm decoder block: ``attn_cache_fn(q, k, v)`` owns the KV
    bookkeeping (serving) or is plain flash attention (training) and returns
    [B, t, H, hd]. Parallel residual, shared norm and biases as the
    reference's block; ``positions`` None means ``arange(T)``."""
    hn1 = _norm(h, wc["ln1"], cfg.norm, cfg.norm_eps)
    q, k, v = qkv_proj(hn1, wc["attn"], cfg)
    if cfg.use_rope:
        q = apply_rope(q, freqs, positions)
        k = apply_rope(k, freqs, positions)
    attn_out = attn_out_proj(attn_cache_fn(q, k, v), wc["attn"], cfg)
    if cfg.parallel_block:
        hn2 = (hn1 if cfg.parallel_shared_norm
               else _norm(h, wc["ln2"], cfg.norm, cfg.norm_eps))
        return h + attn_out + mlp_block(hn2, wc["mlp"], cfg)
    h = h + attn_out
    hn2 = _norm(h, wc["ln2"], cfg.norm, cfg.norm_eps)
    return h + mlp_block(hn2, wc["mlp"], cfg)


def transformer_block(x: torch.Tensor, w: Params, cfg: TransformerConfig,
                      freqs: Optional[torch.Tensor]) -> torch.Tensor:
    """One decoder block of the training forward over the whole sequence:
    the counterpart of ``transformer_block`` (:526) and ``attention_block``
    (:413, without the fpdt tier), causal flash attention with the layer's
    window. ``w`` holds one layer's weights in the compute dtype."""
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    def attend(q, k, v):
        return flash_attention(q, k, v, causal=True, window=cfg.sliding_window)

    return _decode_block(x, w, cfg, freqs, None, attend)


def lm_loss(cfg: TransformerConfig, logits: torch.Tensor,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token / labeled cross-entropy with masking and optional z-loss,
    in fp32 (the reference's ``lm_loss`` :568)."""
    ids = batch["input_ids"]
    if "labels" in batch:
        labels = batch["labels"]
        lmask = labels >= 0
        labels = labels.clamp_min(0)
        lg = logits
    else:                                           # next-token LM loss
        labels, lg = ids[:, 1:], logits[:, :-1]
        lmask = (batch["attention_mask"][:, 1:].bool()
                 if "attention_mask" in batch
                 else torch.ones_like(labels, dtype=torch.bool))
    lg = lg.float()
    logz = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, labels[..., None].long())[..., 0]
    nll = logz - gold
    if cfg.z_loss > 0.0:
        nll = nll + cfg.z_loss * logz.square()
    denom = lmask.sum().clamp_min(1)
    return torch.where(lmask, nll, 0.0).sum() / denom


def _unstack(layers: Params, dt: torch.dtype) -> Dict[str, Dict[str, tuple]]:
    """Every stacked leaf cast to ``dt`` once (fp32 masters; the cast's
    backward returns fp32 gradients) and split into its per-layer views
    with ``unbind``, whose backward stacks the layers' gradients into one
    tensor (indexing ``p[i]`` per layer would allocate a full-size gradient
    per layer)."""
    return {grp: {n: (p.to(dt) if p.dtype == torch.float32 else p).unbind(0)
                  for n, p in sub.items()}
            for grp, sub in layers.items()}


def _layer(layers: Dict[str, Dict[str, tuple]], i: int) -> Params:
    """Layer ``i``'s weights from :func:`_unstack`'s views."""
    return {grp: {n: ts[i] for n, ts in sub.items()}
            for grp, sub in layers.items()}


def _layer_views(layers: Params, dt: torch.dtype) -> Callable[[int], Params]:
    """``i -> layer i's weights`` of a serving tree: the dense leaves as
    :func:`_unstack` views, each stacked :class:`QuantizedWeight` as a
    :class:`QuantLayerRef` to layer ``i``."""
    dense, quant = split_quant_leaves(layers)
    views = _unstack(dense, dt)

    def at(i: int) -> Params:
        wc = _layer(views, i)
        for grp, name, qw in quant:
            wc[grp][name] = QuantLayerRef(qw, i)
        return wc
    return at


class TransformerLM:
    """The decoder-only LM family: parameter init, a plain full-sequence
    forward (:meth:`logits`), the three serving entry points of the packed
    paged engine and the two dense-tile ones (paged pool, dense cache)."""

    MAX_ATOM = 256       # widest prefill atom; engines chunk longer prompts
    PREFILL_MAX = 4096   # widest whole-prompt prefill

    def __init__(self, cfg: TransformerConfig):
        if cfg.num_experts > 1:
            raise NotImplementedError("MoE layers are not ported yet")
        # auto/flash: flash attention, which is kernel D on CUDA tensors and
        # its plain version on CPU ones. No knob moves card work elsewhere.
        if cfg.attention_impl not in ("auto", "flash"):
            raise NotImplementedError(
                f"attention_impl={cfg.attention_impl!r} is not ported "
                "(the port has one attention path: auto/flash)")
        self.cfg = cfg
        self._freqs: Dict[torch.device, torch.Tensor] = {}

    def freqs(self, device) -> Optional[torch.Tensor]:
        """Rotary table on ``device`` (computed once per device, fp32)."""
        cfg = self.cfg
        if not cfg.use_rope:
            return None
        device = torch.device(device)
        f = self._freqs.get(device)
        if f is None:
            f = rope_frequencies(cfg.rope_dim, cfg.max_seq_len,
                                 cfg.rope_theta, cfg.rope_scaling,
                                 device=device)
            self._freqs[device] = f
        return f

    # ---- init -------------------------------------------------------------
    def init(self, seed: int = 0, device="cuda") -> Params:
        """Random parameters drawn on ``device`` from a ``torch.Generator``
        seeded with ``seed`` (the same scales as the reference; not the same
        numbers -- tests bridge the reference's params instead)."""
        from deepspeed_tpu_torch.utils import resolve_device

        device = resolve_device(device)
        cfg = self.cfg
        pd = torch_dtype(cfg.param_dtype)
        D, Fd, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        hd, H, K, L = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.num_layers
        g = torch.Generator(device=device).manual_seed(seed)

        def normal(shape, scale):
            t = torch.randn(shape, generator=g, device=device, dtype=pd)
            return t.mul_(scale)

        def stack(fan_in, shape):
            return normal((L,) + shape, 1.0 / math.sqrt(fan_in))

        def const(shape, value):
            return torch.full(shape, value, dtype=pd, device=device)

        def norm_w():
            w = {"scale": const((L, D), 1.0)}
            if cfg.norm == "layernorm":
                w["bias"] = const((L, D), 0.0)
            return w

        attn = {"wq": stack(D, (D, H * hd)), "wk": stack(D, (D, K * hd)),
                "wv": stack(D, (D, K * hd)), "wo": stack(H * hd, (H * hd, D))}
        if cfg.qkv_bias:
            attn["bq"] = const((L, H * hd), 0.0)
            attn["bk"] = const((L, K * hd), 0.0)
            attn["bv"] = const((L, K * hd), 0.0)
        if cfg.proj_bias:
            attn["bo"] = const((L, D), 0.0)
        if cfg.activation == "swiglu":
            mlp = {"w_gate": stack(D, (D, Fd)), "w_up": stack(D, (D, Fd)),
                   "w_down": stack(Fd, (Fd, D))}
        else:
            mlp = {"w_up": stack(D, (D, Fd)), "w_down": stack(Fd, (Fd, D))}
            if cfg.proj_bias:
                mlp["b_up"] = const((L, Fd), 0.0)
                mlp["b_down"] = const((L, D), 0.0)
        layers: Params = {"ln1": norm_w(), "attn": attn, "mlp": mlp}
        if not cfg.parallel_shared_norm:
            layers["ln2"] = norm_w()
        params: Params = {"embed": {"tokens": normal((V, D), 0.02)},
                          "layers": layers,
                          "final_norm": {"scale": torch.ones(D, dtype=pd,
                                                             device=device)}}
        if cfg.norm == "layernorm":
            params["final_norm"]["bias"] = torch.zeros(D, dtype=pd,
                                                       device=device)
        if cfg.learned_pos:
            params["embed"]["pos"] = normal((cfg.max_seq_len, D), 0.01)
        if not cfg.tie_embeddings:
            params["lm_head"] = normal((D, V), 1.0 / math.sqrt(D))
        return params

    # ---- shared pieces ----------------------------------------------------
    def _head(self, params: Params):
        """The [D, V] output projection: a serving engine's quantized
        ``lm_head_q``, else the tied ``embed.tokens.T`` or ``lm_head``."""
        if "lm_head_q" in params:
            return params["lm_head_q"]
        return (params["embed"]["tokens"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def _head_proj(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        """``x [..., D] @ head`` (kernel G for a quantized head)."""
        head = self._head(params)
        if isinstance(head, QuantizedWeight):
            return linear(x, head)
        return x @ head.to(torch_dtype(self.cfg.dtype))

    def _embed(self, params: Params, ids: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        x = params["embed"]["tokens"][ids.long()].to(dt)
        if cfg.learned_pos:
            safe = torch.clamp_max(positions.long(), cfg.max_seq_len - 1)
            x = x + params["embed"]["pos"][safe].to(dt)
        return x

    def _tile_positions(self, pos: torch.Tensor, t: int):
        """(positions [B, t] of a dense tile from each slot's ``pos``, the
        same clamped to the rotary table for rope). A padded row of a slot
        at a deep ``pos`` can pass the table; the reference's gather clamps
        such an index, so the port clamps it too (the row is don't-care)."""
        positions = pos.long()[:, None] + torch.arange(t, device=pos.device)
        return positions, torch.clamp_max(positions, self.cfg.max_seq_len - 1)

    def _window_segments(self):
        """Contiguous layer runs sharing one window setting:
        ``[(lo, hi, cfg_segment)]``; layers below ``window_start_layer``
        attend fully (HF qwen2 ``max_window_layers``)."""
        cfg = self.cfg
        ws = cfg.window_start_layer
        if cfg.sliding_window is None or ws <= 0:
            return [(0, cfg.num_layers, cfg)]
        ws = min(ws, cfg.num_layers)
        segs = [(0, ws, dataclasses.replace(cfg, sliding_window=None,
                                            window_start_layer=0))]
        if ws < cfg.num_layers:
            segs.append((ws, cfg.num_layers,
                         dataclasses.replace(cfg, window_start_layer=0)))
        return segs

    def _layers(self):
        """(layer index, that layer's config) over every segment."""
        for lo, hi, cseg in self._window_segments():
            for i in range(lo, hi):
                yield i, cseg

    # ---- full-sequence forward and the training loss ---------------------
    def hidden_states(self, params: Params,
                      input_ids: torch.Tensor) -> torch.Tensor:
        """Final-norm hidden states [B, T, D] (the reference's
        ``hidden_states`` :745, dense path): each layer runs under the
        ``remat_policy``'s activation checkpointing, with its window
        segment's config."""
        from deepspeed_tpu_torch.runtime.activation_checkpointing import (
            checkpoint_wrapper)

        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        B, T = input_ids.shape
        pos = torch.arange(T, device=input_ids.device)[None].expand(B, T)
        x = self._embed(params, input_ids, pos)
        freqs = self.freqs(input_ids.device)
        layer_at = _layer_views(params["layers"], dt)
        block = checkpoint_wrapper(transformer_block, cfg.remat_policy)
        for i, cseg in self._layers():
            x = block(x, layer_at(i), cseg, freqs)
        return _norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)

    def logits(self, params: Params, input_ids: torch.Tensor) -> torch.Tensor:
        """[B, T] ids -> [B, T, V] logits (the parity oracle of the serving
        paths)."""
        return self._head_proj(params, self.hidden_states(params, input_ids))

    def loss_fn(self, params: Params, batch: Dict[str, torch.Tensor],
                rng=None) -> torch.Tensor:
        """Scalar training loss of one micro-batch (the reference's
        ``loss_fn`` :914, untiled): ``batch`` holds ``input_ids`` [B, T] and
        optionally ``labels`` / ``attention_mask``."""
        cfg = self.cfg
        if "ltd_seed" in batch or "pld_theta" in batch:
            raise NotImplementedError("random-LTD and progressive layer drop "
                                      "are not ported yet")
        if cfg.loss_tiling > 1:
            raise NotImplementedError("loss_tiling > 1 (the tiled logits "
                                      "loss) is not ported yet")
        logits = self.logits(params, batch["input_ids"])
        return lm_loss(cfg, logits, batch)

    # ---- paged serving path ----------------------------------------------
    def init_paged_kv_cache(self, num_blocks: int, block_size: int = 128,
                            device="cuda", quantize: bool = False,
                            bits: int = 8) -> Dict[str, torch.Tensor]:
        """The global blocked KV pool, lane-folded
        ``[L, num_blocks+1, block_size, K*d]`` in the compute dtype; the last
        block is scratch for padded lanes. ``quantize=True`` allocates int8
        pools (``bits=4``: ``K*d/2`` lanes, feature ``j`` paired with
        ``j + K*d/2`` per byte) and the per-token dequant scales
        ``kv_scale [L, num_blocks+1, 1, 2*block_size]`` (k scales in lanes
        ``[0, bs)``, v in ``[bs, 2bs)``)."""
        from deepspeed_tpu_torch.utils import resolve_device

        cfg = self.cfg
        device = resolve_device(device)
        lanes = cfg.num_kv_heads * cfg.head_dim
        if quantize and bits == 4:
            if cfg.head_dim % 2:
                raise ValueError("int4 KV needs an even head_dim")
            lanes //= 2
        shape = (cfg.num_layers, num_blocks + 1, block_size, lanes)
        if quantize:
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "kv_scale": torch.zeros(shape[:2] + (1, 2 * block_size),
                                            dtype=torch.float32,
                                            device=device)}
        dt = torch_dtype(cfg.dtype)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    def init_kv_cache(self, batch_size: int,
                      max_seq_len: Optional[int] = None,
                      device="cuda") -> Dict[str, torch.Tensor]:
        """A dense per-layer KV cache (the reference's :933): ``k``/``v``
        ``[L, batch, S, K, d]`` in the compute dtype and the per-row ``pos``
        [batch] int32."""
        from deepspeed_tpu_torch.utils import resolve_device

        cfg = self.cfg
        device = resolve_device(device)
        S = max_seq_len or cfg.max_seq_len
        dt = torch_dtype(cfg.dtype)
        shape = (cfg.num_layers, batch_size, S, cfg.num_kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device),
                "pos": torch.zeros(batch_size, dtype=torch.int32,
                                   device=device)}

    def forward_with_cache(self, params: Params, input_ids: torch.Tensor,
                           cache: Dict[str, torch.Tensor]):
        """Prefill/decode step over the dense cache (the reference's :943,
        whose ``valid`` only feeds MoE routing, not ported): append
        ``input_ids`` [B, t] at each row's ``cache["pos"]`` and return
        (logits [B, t, V], ``{k, v, pos + t}``). ``k``/``v`` are written in
        place; every row advances by ``t`` (the engine restores the true
        positions of padded rows). Writes at positions past the cache are
        dropped, as the reference's scatter drops them. Attention is
        :func:`_cached_attention`."""
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        B, t = input_ids.shape
        S = cache["k"].shape[2]
        positions, rope_pos = self._tile_positions(cache["pos"], t)
        x = self._embed(params, input_ids, positions)
        freqs = self.freqs(input_ids.device)
        rows = torch.arange(B, device=input_ids.device)[:, None].expand(B, t)
        inside = positions < S
        wb, wp = rows[inside], positions[inside]
        sidx = torch.arange(S, device=input_ids.device)[None, None, :]
        layer_at = _layer_views(params["layers"], dt)
        for i, cseg in self._layers():
            wc = layer_at(i)
            vmask = sidx <= positions[:, :, None]                # [B, t, S]
            if cseg.sliding_window is not None:
                vmask = vmask & (sidx > positions[:, :, None]
                                 - cseg.sliding_window)

            def attend(q, k, v, _i=i, _m=vmask):
                ck, cv = cache["k"][_i], cache["v"][_i]
                ck[wb, wp] = k[inside].to(ck.dtype)
                cv[wb, wp] = v[inside].to(cv.dtype)
                return _cached_attention(q, ck, cv, _m)

            x = _decode_block(x, wc, cseg, freqs, rope_pos, attend)
        x = _norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        return self._head_proj(params, x), {
            "k": cache["k"], "v": cache["v"],
            "pos": cache["pos"] + t}

    def forward_with_paged_cache(self, params: Params,
                                 input_ids: torch.Tensor,
                                 cache: Dict[str, torch.Tensor],
                                 block_tables: torch.Tensor,
                                 pos: torch.Tensor,
                                 valid: Optional[torch.Tensor] = None):
        """Continuous-batching step of the ``packed=False`` engine over the
        paged pool (the reference's :1047): ``input_ids`` [B, t] a dense
        tile (per-slot chunks right-padded), ``block_tables`` [B, nb_max],
        ``pos`` [B] tokens cached per slot, ``valid`` [B, t] real lanes.
        Each layer first writes the tile's K/V into its blocks
        (:func:`paged_update`; invalid lanes to the scratch block), then
        runs kernel I (:func:`paged_attention`) over them. Returns (logits
        [B, t, V], cache) -- the pools are updated in place."""
        from deepspeed_tpu_torch.ops.paged_attention import (paged_attention,
                                                             paged_update)

        if "kv_scale" in cache:
            raise NotImplementedError(
                "the dense-tile escape hatch does not support the int8 KV "
                "pool; use the packed path (packed=True)")
        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        t = input_ids.shape[1]
        positions, rope_pos = self._tile_positions(pos, t)
        x = self._embed(params, input_ids, positions)
        freqs = self.freqs(input_ids.device)
        layer_at = _layer_views(params["layers"], dt)
        for i, cseg in self._layers():
            wc = layer_at(i)

            def attend(q, k, v, _i=i, _w=cseg.sliding_window):
                paged_update(cache["k"][_i], k, block_tables, pos, valid)
                paged_update(cache["v"][_i], v, block_tables, pos, valid)
                return paged_attention(q, cache["k"], cache["v"],
                                       block_tables, pos, window=_w,
                                       layer=_i)

            x = _decode_block(x, wc, cseg, freqs, rope_pos, attend)
        x = _norm(x, params["final_norm"], cfg.norm, cfg.norm_eps)
        return self._head_proj(params, x), cache

    def _kv_bits(self, cache) -> int:
        """4 when the paged pool is int4-packed (``K*d/2`` lanes), else 8."""
        if "kv_scale" not in cache:
            return 8
        half = self.cfg.num_kv_heads * self.cfg.head_dim // 2
        return 4 if cache["k"].shape[-1] == half else 8

    def forward_prefill(self, params: Params, input_ids: torch.Tensor,
                        lengths: torch.Tensor):
        """Whole-prompt prefill of fresh prompts: causal flash attention over
        ``input_ids`` [B, T] (right-padded; ``lengths`` [B]). Returns
        (last-token logits [B, V], kv {k, v: [L, B, T, K, d]}) for the engine
        to fold into the pool with one scatter."""
        from deepspeed_tpu_torch.ops.flash_attention import flash_attention

        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        B, T = input_ids.shape
        dev = input_ids.device
        positions = torch.arange(T, device=dev)[None].expand(B, T)
        x = self._embed(params, input_ids, positions)
        freqs = self.freqs(dev)
        K, hd = cfg.num_kv_heads, cfg.head_dim
        kr = torch.empty(cfg.num_layers, B, T, K, hd, dtype=dt, device=dev)
        vr = torch.empty_like(kr)
        layer_at = _layer_views(params["layers"], dt)
        for i, cseg in self._layers():
            wc = layer_at(i)

            def attend(q, k, v, _i=i, _w=cseg.sliding_window):
                kr[_i], vr[_i] = k, v
                return flash_attention(q, k, v, causal=True, window=_w)

            x = _decode_block(x, wc, cseg, freqs, positions, attend)
        last = torch.clamp(lengths.long() - 1, 0, T - 1)
        xg = x[torch.arange(B, device=dev), last]
        xg = _norm(xg, params["final_norm"], cfg.norm, cfg.norm_eps)
        return self._head_proj(params, xg), {"k": kr, "v": vr}

    def forward_with_packed_cache(self, params: Params,
                                  token_ids: torch.Tensor,
                                  cache: Dict[str, torch.Tensor],
                                  block_tables: torch.Tensor,
                                  tok_slot: torch.Tensor,
                                  tok_pos: torch.Tensor, valid: torch.Tensor,
                                  gather_idx: torch.Tensor,
                                  decode_rows: Optional[int] = None,
                                  tile_tq: int = 128,
                                  tiles_no_past: bool = False):
        """Token-packed continuous-batching step: ``token_ids`` [N] in two
        regions -- rows ``[0, decode_rows)`` are 1-token atoms, the rest
        ``tile_tq``-wide atoms each holding one whole chunk (right-padded).
        Attention reads only PAST steps' KV from the pool; this step's KV of
        every layer is appended after the layer loop with one in-place
        scatter per pool. Returns (logits [G, V] at ``gather_idx``, cache)
        -- the cache dict's tensors are updated in place."""
        from deepspeed_tpu_torch.ops.paged_attention import (
            cache_append, ragged_paged_attention)

        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        kv = dict(kv_scale=cache.get("kv_scale"), kv_bits=self._kv_bits(cache))
        N = token_ids.shape[0]
        dr = N if decode_rows is None else decode_rows
        if (N - dr) % tile_tq:
            raise ValueError(f"prefill region ({N} - {dr} rows) must be a "
                             f"multiple of the {tile_tq}-token atom tile")
        n_tiles = (N - dr) // tile_tq
        positions = tok_pos[:, None]                             # [N, 1]
        x = self._embed(params, token_ids, tok_pos)[:, None, :]
        freqs = self.freqs(token_ids.device)
        a_slot_d, a_pos_d = tok_slot[:dr], tok_pos[:dr]
        a_len_d = valid[:dr].to(torch.int32)
        if n_tiles:
            a_slot_t = tok_slot[dr::tile_tq]
            a_pos_t = tok_pos[dr::tile_tq]
            a_len_t = valid[dr:].reshape(n_tiles, tile_tq).sum(
                dim=1, dtype=torch.int32)
        K, hd = cfg.num_kv_heads, cfg.head_dim
        krows = torch.empty(cfg.num_layers, N, K, hd, dtype=dt,
                            device=token_ids.device)
        vrows = torch.empty_like(krows)
        layer_at = _layer_views(params["layers"], dt)
        for i, cseg in self._layers():
            wc = layer_at(i)

            def attend(q, k, v, _i=i, _w=cseg.sliding_window):
                q2, k2, v2 = q[:, 0], k[:, 0], v[:, 0]           # [N, H|K, d]
                krows[_i], vrows[_i] = k2, v2
                parts = []
                if dr:
                    parts.append(ragged_paged_attention(
                        q2[:dr], k2[:dr], v2[:dr], cache["k"], cache["v"],
                        block_tables, a_slot_d, a_pos_d, a_len_d, tq=1,
                        window=_w, layer=_i, **kv))
                if n_tiles:
                    parts.append(ragged_paged_attention(
                        q2[dr:], k2[dr:], v2[dr:], cache["k"], cache["v"],
                        block_tables, a_slot_t, a_pos_t, a_len_t,
                        tq=tile_tq, window=_w, layer=_i,
                        no_past=tiles_no_past, **kv))
                out = parts[0] if len(parts) == 1 else torch.cat(parts)
                return out[:, None]                              # [N,1,H,d]

            x = _decode_block(x, wc, cseg, freqs, positions, attend)
        cache_append(cache, krows, vrows, block_tables, tok_slot, tok_pos,
                     valid)
        x = _norm(x[:, 0][gather_idx.long()], params["final_norm"], cfg.norm,
                  cfg.norm_eps)
        return self._head_proj(params, x), cache

    def forward_decode_tail(self, params: Params, toks: torch.Tensor,
                            cache: Dict[str, torch.Tensor],
                            tail: Dict[str, torch.Tensor], t: int,
                            block_tables: torch.Tensor, slots: torch.Tensor,
                            pos_base: torch.Tensor,
                            valid: Optional[torch.Tensor] = None):
        """One step of the fused decode loop with the pool READ-ONLY: this
        call's decoded KV lives in the dense ``tail`` [L, B, steps, K, d]
        (written in place at step ``t``) and the engine folds it into the
        pool once after the loop. Attention = pool partials (kernel A over
        positions < pos_base, window anchored at the row position
        ``pos_base + t``) merged with the tail columns <= t. Returns
        (logits [B, V], tail)."""
        from deepspeed_tpu_torch.ops.paged_attention import (
            decode_pool_partials)

        cfg = self.cfg
        dt = torch_dtype(cfg.dtype)
        B = toks.shape[0]
        K, hd = cfg.num_kv_heads, cfg.head_dim
        rep = cfg.num_heads // K
        H = K * rep
        if valid is None:
            valid = torch.ones(B, dtype=torch.bool, device=toks.device)
        row_pos = pos_base + t                                   # [B]
        positions = row_pos[:, None]
        x = self._embed(params, toks, row_pos)[:, None, :]
        freqs = self.freqs(toks.device)
        scale = 1.0 / math.sqrt(hd)
        S_tail = tail["k"].shape[2]
        col = torch.arange(S_tail, device=toks.device)
        tk, tv = tail["k"], tail["v"]
        kv = dict(kv_scale=cache.get("kv_scale"), kv_bits=self._kv_bits(cache))
        layer_at = _layer_views(params["layers"], dt)
        for i, cseg in self._layers():
            wc = layer_at(i)

            def attend(q, k, v, _i=i, _w=cseg.sliding_window):
                q2, k2, v2 = q[:, 0], k[:, 0], v[:, 0]           # [B, H|K, d]
                acc, m_k, l_k = decode_pool_partials(
                    q2, cache["k"], cache["v"], _i, block_tables, slots,
                    pos_base, window=_w, row_pos=row_pos, **kv)
                tk[_i, :, t], tv[_i, :, t] = k2, v2
                qg = q2.reshape(B, K, rep, hd).float()
                s_t = torch.einsum("bkrd,bskd->bkrs", qg,
                                   tk[_i].float()) * scale
                keep = col <= t
                if _w is not None:
                    keep = keep & (col > t - _w)
                s_t = torch.where(keep, s_t, -1e30)
                m_t = s_t.amax(dim=-1)                           # [B, K, rep]
                p_t = torch.where(keep, torch.exp(s_t - m_t[..., None]), 0.0)
                l_t = p_t.sum(dim=-1)
                acc_t = torch.einsum("bkrs,bskd->bkrd", p_t, tv[_i].float())
                m_t, l_t = m_t.reshape(B, H), l_t.reshape(B, H)
                acc_t = acc_t.reshape(B, H, hd)
                m2 = torch.maximum(m_k, m_t)
                c_k = torch.exp(m_k - m2)
                c_t = torch.exp(m_t - m2)
                denom = torch.clamp_min(l_k * c_k + l_t * c_t, 1e-30)
                out = ((acc * c_k[..., None] + acc_t * c_t[..., None])
                       / denom[..., None])
                out = torch.where(valid[:, None, None], out, 0.0)
                return out.to(q.dtype)[:, None]                  # [B,1,H,d]

            x = _decode_block(x, wc, cseg, freqs, positions, attend)
        x = _norm(x[:, 0], params["final_norm"], cfg.norm, cfg.norm_eps)
        return self._head_proj(params, x), tail
