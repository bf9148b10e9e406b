"""Self-drafting (prompt-lookup / n-gram) speculative decoding (counterpart
of ``deepspeed_tpu/inference/speculative.py``; host numpy).

No draft model: when the last ``ngram`` tokens of a sequence occurred
before in its own history, the tokens that followed that earlier occurrence
are proposed as the next ``max_draft`` tokens. The engine verifies every
draft in one batched forward (``InferenceEngineV2.spec_decode_round``) and
keeps the longest prefix the model itself produces, so greedy output is the
non-speculative output.
"""

from __future__ import annotations

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

__all__ = ["ngram_draft"]


def ngram_draft(history, ngram: int, max_draft: int) -> np.ndarray:
    """Up to ``max_draft`` tokens that followed the most recent earlier
    occurrence of the history's trailing n-gram (backing off from
    ``ngram`` to 1). Empty when the history never repeats."""
    h = np.atleast_1d(np.asarray(history)).ravel()
    L = int(h.size)
    if L < 2 or max_draft < 1:
        return h[:0]
    for m in range(min(int(ngram), L - 1), 0, -1):
        pat = h[L - m:]
        body = h[:L - 1]                      # not the trailing n-gram itself
        if body.size < m:
            continue
        eq = np.flatnonzero((sliding_window_view(body, m) == pat).all(axis=1))
        if eq.size:
            s = int(eq[-1])                   # most recent occurrence
            cont = h[s + m: s + m + int(max_draft)]
            if cont.size:
                return np.asarray(cont, h.dtype)
    return h[:0]
