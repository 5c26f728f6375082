"""Seconds from the start of the process to the start of the window:
imports, chemistry, the objective's set-up and build, the warm-up calls."""


def read(run):
    return run.setup_s
