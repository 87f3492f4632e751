"""A frozen copy of the port's plain overlap path (smartdenovo_tpu_torch/
ops/{flatops,seeds,flatseeds,candidates,dotmatrix}.py as they stood when
the benchmark was written), its hand kernels replaced by their plain
PyTorch versions (kernels_plain.py).  It is the yardstick: later changes
to the program do not change it."""
