"""Continuous-batching inference engine over a paged KV pool (counterpart of
``deepspeed_tpu/inference/engine_v2.py`` ``InferenceEngineV2``).

Ported scope: one device, greedy decoding; weights in the compute dtype or
int8/int4 (``weight_dtype``: kernels G/H through the model's ``linear()``
seam). Three engines, as the reference's flags pick them:

* ``paged=True, packed=True`` (default): a KV pool in the compute dtype or
  int8/int4 with per-token scales (``kv_dtype``: the int modes of kernels
  A/B). ``put`` runs fresh whole prompts through ``forward_prefill``
  (flash kernel D) and everything else through the packed step
  ``forward_with_packed_cache`` (paged kernels A/B and the seeded flash
  C); ``decode_batch`` runs ``steps`` greedy tokens with the pool
  read-only and folds the new KV in once.
* ``packed=False``: the same pool, but ``put`` runs one dense
  ``[max_sequences, t_max]`` tile (every slot a row) through
  ``forward_with_paged_cache`` (kernel I), unchunked;
* ``paged=False``: a dense ``[L, max_sequences, max_seq_len, K, d]``
  cache and the same tile through ``forward_with_cache`` (plain torch
  attention, as the reference's is XLA).

The last two take bf16 KV only and have no ``decode_batch`` (the
reference's raises). Host-side scheduling (slots, blocks, block tables,
atom packing) mirrors the reference line for line.

Not ported yet (they raise): sampling, prefix cache, speculative
decoding, KV tiers, pause/resume, MoE and tensor parallelism.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from deepspeed_tpu_torch.inference.ragged import (CapacityError,
                                                  SequenceManager)
from deepspeed_tpu_torch.inference.quant import quantize_serving_params
from deepspeed_tpu_torch.models.transformer import TransformerLM, torch_dtype
from deepspeed_tpu_torch.ops.paged_attention import cache_append
from deepspeed_tpu_torch.utils import resolve_device

# packed-row atom layout: 1-token chunks are decode atoms; longer chunks
# each occupy one whole-chunk atom of bucketed width
_MIN_TILE = 32


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class InferenceEngineV2:
    def __init__(self, model: TransformerLM, params=None,
                 max_sequences: int = 8, max_seq_len: Optional[int] = None,
                 block_size: int = 128, num_blocks: Optional[int] = None,
                 paged: bool = True, packed: bool = True,
                 kv_dtype: str = "bf16", weight_dtype: str = "bf16",
                 device="cuda", seed: int = 0):
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
        cdt = torch_dtype(self.cfg.dtype)
        if params is None:
            params = model.init(seed=seed, device=self.device)
        # serving holds weights in the compute dtype (the reference's
        # _serve_cast): fp32 leaves are cast once, here
        params = _tree_map(
            lambda p: p.to(device=self.device,
                           dtype=cdt if p.dtype == torch.float32 else p.dtype),
            params)
        if weight_dtype != "bf16":
            # decode reads every weight once a step: packed leaves cut those
            # bytes 2x (int8) / 4x (int4); the forward paths pick them up
            # through the model's linear() seam
            params = quantize_serving_params(
                params, self.cfg, bits=4 if weight_dtype == "int4" else 8)
        self.params = params
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

    def _t(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
        logits = self._prefill_impl(self._t(ids), self._t(lengths),
                                    self._t(self._block_tables()),
                                    self._t(slots))
        out = logits.float().cpu().numpy()
        results = {}
        for i, (d, c) in enumerate(zip(descs, chunks)):
            results[d.uid] = out[i]
            self._pos[d.slot] = d.seen_tokens + len(c)
            self.state.commit(d.uid)
        return results

    # ---- packed continuous-batching step ---------------------------------
    def _pack_atoms(self, descs, chunks):
        """The packed two-region atom layout: decode rows (bucketed to a
        power of two >= 8), then one pow2-wide tile atom per longer chunk.
        Returns ``(tok_ids, tok_slot, tok_pos, valid, starts, dr, tile,
        no_past)``."""
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

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[np.ndarray]) -> Dict[int, np.ndarray]:
        """Advance every listed sequence by its token chunk; returns the
        next-token logits per uid (fp32 numpy [V]). Chunks may be whole
        prompts, single decode tokens, or anything between."""
        if len(batch_uids) != len(batch_tokens):
            raise ValueError("one token chunk per uid")
        chunks = [np.atleast_1d(np.asarray(t)) for t in batch_tokens]
        if not self.packed:
            return self._put_dense_tile(batch_uids, chunks)
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
        if not self.state.can_schedule_batch(batch_uids,
                                             [len(c) for c in chunks]):
            raise CapacityError(batch_uids, [len(c) for c in chunks])
        descs = [self.state.schedule(uid, len(toks))
                 for uid, toks in zip(batch_uids, chunks)]
        tok_ids, tok_slot, tok_pos, valid, starts, dr, tile, no_past = \
            self._pack_atoms(descs, chunks)
        gather_idx = np.zeros((self.state.max_sequences,), np.int32)
        for i, c in enumerate(chunks):               # chunk end -> next token
            gather_idx[i] = starts[i] + len(c) - 1
        logits, self.cache = self.module.forward_with_packed_cache(
            self.params, self._t(tok_ids), self.cache,
            self._t(self._block_tables()), self._t(tok_slot),
            self._t(tok_pos), self._t(valid), self._t(gather_idx), dr, tile,
            no_past)
        out = logits.float().cpu().numpy()
        results: Dict[int, np.ndarray] = {}
        for i, (d, c) in enumerate(zip(descs, chunks)):
            results[d.uid] = out[i]
            self._pos[d.slot] = d.seen_tokens + len(c)
            self.state.commit(d.uid)
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
                self.params, self._t(tile), self.cache)
            pos = self.cache["pos"].cpu().numpy().copy()
        out = logits[slots, ends].float().cpu().numpy()
        del logits
        results: Dict[int, np.ndarray] = {}
        for i, (d, c) in enumerate(zip(descs, chunks)):
            results[d.uid] = out[i]
            pos[d.slot] = d.seen_tokens + len(c)
            self.state.commit(d.uid)
        if not self.paged:        # idle rows keep their true positions
            self.cache["pos"] = self._t(pos)
        return results

    # ---- fused multi-step decode -----------------------------------------
    def _multi_decode(self, bt, slots, pos0, tok0, steps: int, valid):
        """``steps`` greedy decode iterations with the pool READ-ONLY: new KV
        accumulates in a dense tail [L, B, steps, K, d] that attention reads
        as a third flash-decode segment, and one scatter per pool folds it
        in after the loop. Returns the tokens [steps, B] on the device."""
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
                     temperature: float = 0.0) -> Dict[int, np.ndarray]:
        """Advance every listed sequence ``steps`` greedy tokens from its
        ``batch_tokens`` entry; returns the generated tokens per uid
        ([steps] int32 each). One fetch regardless of ``steps``."""
        if not self.packed:
            raise ValueError("decode_batch needs the packed paged engine")
        if temperature != 0.0:
            raise NotImplementedError("sampling is not ported yet (greedy "
                                      "decoding only)")
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
        out = self._multi_decode(self._t(self._block_tables()),
                                 self._t(slots), self._t(pos0),
                                 self._t(tok0), steps, self._t(valid))
        toks = out.cpu().numpy()                        # [steps, bpad]
        for d in descs:
            self._pos[d.slot] = d.seen_tokens + steps
            self.state.commit(d.uid)
        return {d.uid: toks[:, i] for i, d in enumerate(descs)}
