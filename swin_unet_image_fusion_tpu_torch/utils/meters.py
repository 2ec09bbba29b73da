"""Windowed loss means on the host (copy of the JAX ``utils/meters.py``): the trainer
records each step's terms once it has fetched them, and ``mean_and_clear`` returns the
means rounded to 5 decimals, as the reference's loss recorder does."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class LossMeter:
    def __init__(self):
        self._records: List[Dict[str, float]] = []
        self.history: List[Dict[str, float]] = []  # every mean returned, in order

    def record(self, terms: Dict[str, float]) -> None:
        self._records.append({k: float(v) for k, v in terms.items()})

    def __len__(self) -> int:
        return len(self._records)

    def mean_and_clear(self) -> Dict[str, float]:
        """``{"<term>_mean": mean}`` of everything recorded since the last call, then
        clear; ``{}`` when nothing was recorded."""
        if not self._records:
            return {}
        keys = self._records[0].keys()
        means = {f"{k}_mean": round(float(np.mean([r[k] for r in self._records])), 5) for k in keys}
        self._records.clear()
        self.history.append(means)
        return means
