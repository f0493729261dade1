"""Windowed smoothed meters (vitax/utils/metrics.py SmoothedValue, the
reference's SmoothedValue API: windowed median, windowed weighted average,
global weighted average and the latest value)."""

from __future__ import annotations

from collections import deque


class SmoothedValue:
    """Track a weighted series over a window of recent updates."""

    def __init__(self, window_size: int = 20):
        self.window_size = window_size
        self.reset()

    def reset(self) -> None:
        self._window = deque(maxlen=self.window_size)  # (value, weight) pairs
        self._sum = 0.0     # lifetime sum of value * weight
        self._weight = 0    # lifetime sum of weights
        self._n = 0         # lifetime number of updates

    def update(self, value: float, batch_size: int = 1) -> None:
        value = float(value)
        self._window.append((value, batch_size))
        self._sum += value * batch_size
        self._weight += batch_size
        self._n += 1

    @property
    def count(self) -> int:
        return self._n

    @property
    def median(self) -> float:
        vals = sorted(v for v, _ in self._window)
        n = len(vals)
        if n == 0:
            return float("nan")
        mid = n // 2
        return vals[mid] if n % 2 else 0.5 * (vals[mid - 1] + vals[mid])

    @property
    def avg(self) -> float:
        denom = sum(w for _, w in self._window)
        if not denom:
            return float("nan")
        return sum(v * w for v, w in self._window) / denom

    @property
    def global_avg(self) -> float:
        return self._sum / self._weight if self._weight else float("nan")

    def get_latest(self) -> float:
        return self._window[-1][0] if self._window else float("nan")
