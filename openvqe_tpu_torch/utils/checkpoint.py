"""ADAPT-VQE checkpoint/resume.

The reference restarts long ADAPT runs from scratch (SURVEY.md §5: no
checkpointing).  Here each outer iteration can persist (selected operator
indices, parameters, norms, iteration metrics, RNG state) and a run resumes
exactly where it stopped.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class AdaptState:
    n_iter: int
    op_indices: List[int]
    parameters: List[float]
    prev_norm: float
    last_energy: float
    iterations: Dict[str, List[Any]]
    meta: Dict[str, Any] = field(default_factory=dict)


def save_checkpoint(path: str, state: AdaptState) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    tmp = p.with_suffix(p.suffix + ".tmp")
    with open(tmp, "w") as f:
        json.dump(asdict(state), f, default=_jsonable)
    tmp.replace(p)  # atomic on POSIX


def load_checkpoint(path: str) -> Optional[AdaptState]:
    p = Path(path)
    if not p.exists():
        return None
    with open(p) as f:
        d = json.load(f)
    return AdaptState(**d)


def _jsonable(x):
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    raise TypeError(f"not jsonable: {type(x)}")
