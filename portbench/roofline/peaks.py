"""The card's peaks that a kernel's roofline is priced at: one NVIDIA H100
SXM (80 GB HBM3) at its full power limit of 700 W.

- HBM3: 3.35 TB/s (NVIDIA's data sheet).
- int32: 132 SMs x 64 int32 lanes x 1.98 GHz boost = 16.7 T operations a
  second, derived from the card's spec, not a published figure.

A launch's bound is the larger of its bytes over the HBM rate and its
int32 operations over the int32 rate, every input read once and every
output written once.  A card set below 700 W (nvidia-smi's power.limit,
which each result line carries) runs slower under load, so its shares
read lower against these peaks."""

HBM_BPS = 3.35e12
INT32_OPS = 132 * 64 * 1.98e9


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the least time of the work."""
    tb, to = nbytes / HBM_BPS, ops / INT32_OPS
    return (tb, "bytes") if tb >= to else (to, "operations")
