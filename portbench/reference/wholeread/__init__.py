"""Plain copies of the consensus's whole-read engine, for its first round:
the probe anchoring of each read against its window (`probe.py`), the
semiglobal banded DP along the anchors' band with its traceback
(`banded.py`), and the quality-aware (5q) refine DP around that CIGAR
with its traceback (`refine5q.py`).  Plain PyTorch, NumPy and Python;
nothing of the program."""
