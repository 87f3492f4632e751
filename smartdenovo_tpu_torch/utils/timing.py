"""Host-clock seconds of the parts of a pass, summed into the caller's dict.

The whole-read align pass (pipeline/cns.py `_align_pass`) passes one dict
per iteration down to the refine batches, so the split it logs holds the
probe anchoring, each DP kernel with the fetch of its outputs (which waits
for the device), and the host parts around them.  `split=None` times
nothing.  Each block costs two clock reads.
"""

from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def timed(split: dict | None, key: str):
    """Add the wall seconds of the block to split[key]."""
    if split is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        split[key] = split.get(key, 0.0) + time.perf_counter() - t0
