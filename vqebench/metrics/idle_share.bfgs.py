"""Per cent of the traced window, whole iterations of the loop, with
nothing running on the device."""

from vqebench import shares


def read(run):
    return shares.idle(run, True)
