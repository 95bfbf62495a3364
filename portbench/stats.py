"""The benchmark's frozen statistics over a run's record."""
from __future__ import annotations

from typing import Iterable, Optional

import numpy as np


def percentile(values: Iterable[float], q: float) -> Optional[float]:
    """The q-th percentile, linear between order statistics (numpy's
    default); None for no values."""
    v = np.asarray(list(values), dtype=np.float64)
    return float(np.percentile(v, q)) if v.size else None


def in_window(rec: dict, t: float) -> bool:
    return t <= rec["window"]["seconds"]


def window_waves(rec: dict) -> list:
    """The waves that started inside the window (each ran to its end)."""
    return [w for w in rec["window"]["waves"] if in_window(rec, w["start"])]
