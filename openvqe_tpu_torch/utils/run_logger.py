"""Structured per-iteration run logging + profiling hooks.

The reference logs with bare prints and returns metric dicts (SURVEY.md §5);
here every iteration is appended as a JSON line (machine-readable run
history) and optional `torch.profiler` traces can wrap hot sections.
Copy of ``openvqe_tpu/utils/run_logger.py``; ``profile`` traces with
``torch.profiler`` where the JAX package uses ``jax.profiler``.
"""

from __future__ import annotations

import json
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Any, Dict, Optional


class RunLogger:
    """Append-only JSONL logger with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = Path(path) if path else None
        self.echo = echo
        self._t0 = time.time()
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: Dict[str, Any], kind: str = "iteration") -> None:
        rec = {"kind": kind, "t": round(time.time() - self._t0, 6), **record}
        line = json.dumps(rec, default=_jsonable)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line)

    @contextmanager
    def profile(self, log_dir: Optional[str] = None):
        """torch.profiler trace (CPU and, where present, CUDA activity)
        around a hot section, written to ``log_dir/trace.json`` (viewable in
        Perfetto or chrome://tracing).  No-op when log_dir is None."""
        if log_dir is None:
            yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
        Path(log_dir).mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


def _jsonable(x):
    import numpy as np
    if isinstance(x, (np.floating, np.integer)):
        return x.item()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return str(x)


def read_jsonl(path: str):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
