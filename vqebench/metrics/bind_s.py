"""Seconds of the objective's set-up: VQEObjective, bind and the first
call (operand preparation, kernel builds or loads, graph capture)."""


def read(run):
    return run.bind_s
