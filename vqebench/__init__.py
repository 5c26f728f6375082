"""The port's benchmark: one cell a run (``python3 vqebench/run.py``)."""
