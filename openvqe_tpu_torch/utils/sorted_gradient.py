"""Gradient sorting helpers (API parity with reference
``common_files/sorted_gradient.py``): strip zeros, sort by |value| descending,
recover original indices."""

from __future__ import annotations

from typing import List, Sequence


def value_without_0(values: Sequence[float]) -> List[float]:
    return [v for v in values if v != 0]


def index_without_0(values: Sequence[float]) -> List[int]:
    return [i for i, v in enumerate(values) if v != 0]


def abs_sort_desc(values: Sequence[float]) -> List[float]:
    return sorted(values, key=abs, reverse=True)


def corresponding_index(values: Sequence[float], indices: Sequence[int],
                        sorted_values: Sequence[float]) -> List[int]:
    """Indices (into the original list) of sorted_values, consuming duplicates
    left-to-right (reference sorted_gradient.py:5-20)."""
    remaining = list(zip(values, indices))
    out: List[int] = []
    for sv in sorted_values:
        for k, (v, i) in enumerate(remaining):
            if v == sv:
                out.append(i)
                remaining.pop(k)
                break
    return out
