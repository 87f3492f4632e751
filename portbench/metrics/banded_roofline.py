"""The banded DP's (the SW overlaps' CIGARs) share of its roofline over
every launch in the traced window."""

from portbench.harness.trace import roofline_share


def read(w):
    return roofline_share(w, "banded")
