"""Progressive Layer Dropping (counterpart of
``deepspeed_tpu/runtime/progressive_layer_drop.py``):
``theta(t) = (1 - theta_min) * exp(-gamma * t) + theta_min`` sets the
global keep probability; layer ``i`` (1-based) is kept with the PLD depth
ramp ``p_i = 1 - (i / L) * (1 - theta)``.

The schedule object has the reference's API (``update_state`` /
``get_theta`` / ``get_state``); the model applies it: the engine either
passes ``pld_theta`` with the batch (each layer skipped with probability
``1 - p_i``) or, with ``compiled_tiers``, sets a static depth
(:func:`active_layers`).
"""

from __future__ import annotations

import numpy as np

from deepspeed_tpu_torch.utils.logging import log_dist


class ProgressiveLayerDrop:
    def __init__(self, theta: float = 0.5, gamma: float = 0.001):
        self.theta = float(theta)
        self.gamma = float(gamma)
        self.current_theta = 1.0
        log_dist(f"Enabled progressive layer dropping (theta = {self.theta})")

    def get_state(self):
        return {"progressive_layer_drop": True, "pld_theta": self.get_theta()}

    def get_theta(self) -> float:
        return self.current_theta

    def update_state(self, global_step: int) -> None:
        self.current_theta = ((1.0 - self.theta)
                              * float(np.exp(-self.gamma * global_step))
                              + self.theta)


def layer_keep_probs(theta: float, num_layers: int) -> np.ndarray:
    """Per-layer keep probability under the PLD depth ramp."""
    i = np.arange(1, num_layers + 1)
    return 1.0 - (i / num_layers) * (1.0 - theta)


def active_layers(theta: float, num_layers: int, tiers: int,
                  theta_min: float = 0.5) -> int:
    """Static depth for the compiled-tiers mode: the depth ramp's expected
    kept-layer count ``sum_i p_i = L - (1-theta)(L+1)/2``, quantized
    (rounded UP -- never less compute than the stochastic expectation)
    onto ``tiers`` values between the theta_min-floor depth and L."""
    L = num_layers

    def expect(t):
        return L - (1.0 - t) * (L + 1) / 2.0

    k_floor = max(1, int(np.ceil(expect(theta_min))))
    # tiers=1 degenerates to ONE static depth (k_floor) for the whole run
    grid = np.linspace(k_floor, L, max(tiers, 1))
    k = grid[min(np.searchsorted(grid, expect(theta) - 1e-9),
                 max(tiers, 1) - 1)]
    return int(min(L, max(k_floor, np.ceil(k))))
