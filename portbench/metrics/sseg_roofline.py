"""K1's share of its roofline over every launch in the traced window."""

from portbench.harness.trace import roofline_share


def read(w):
    return roofline_share(w, "sseg")
