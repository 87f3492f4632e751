"""Plain copies of the SW (zmo) engine's tail, beside the frozen dm path
(`reference/dm/`): the top-C chain selection and band of each query
(`sw_align_batch`, `chain_band_params`) with the banded local DP's row
loop (`localdp.py`), and the overlaps' CIGARs: the semiglobal banded
alignment, its traceback, the run-length encoding and the aligned strings
(`cigar.py`).  Plain PyTorch, NumPy and Python; nothing of the program."""
