"""Per cent: the traced calls times the least time of one energy-and-
gradient call (``vqebench/work.py``) over the device's busy time."""

from vqebench import shares


def read(run):
    return shares.call_roofline(run, True)
