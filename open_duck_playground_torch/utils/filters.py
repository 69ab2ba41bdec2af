"""Action filtering utilities. Counterpart of
`open_duck_playground_tpu/utils/filters.py` (reference common/utils.py:1-24,
shipped but disabled at the reference's call sites; kept for parity)."""

from __future__ import annotations

import numpy as np


class LowPassActionFilter:
    """First-order low-pass filter on the action stream."""

    def __init__(self, control_freq: float, cutoff_frequency: float = 37.5):
        self.control_freq = float(control_freq)
        self.cutoff_frequency = float(cutoff_frequency)
        self.alpha = self.compute_alpha()
        self.filtered = None

    def compute_alpha(self) -> float:
        return (1.0 / self.cutoff_frequency) / (
            1.0 / self.control_freq + 1.0 / self.cutoff_frequency
        )

    def push(self, action) -> None:
        action = np.asarray(action, dtype=np.float64)
        if self.filtered is None:
            self.filtered = action.copy()
        else:
            self.filtered = self.alpha * self.filtered + (1 - self.alpha) * action

    def get_filtered_action(self):
        return self.filtered

    def reset(self) -> None:
        self.filtered = None
