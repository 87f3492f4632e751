"""smartdenovo_tpu_torch — the dmo assembler on PyTorch and hand CUDA kernels.

A port of the JAX package `smartdenovo_tpu` to PyTorch for one NVIDIA
H100.  The JAX package is the reference: every module here mirrors the
module of the same name there and is held equal to it by the tests.

- ``ops``       seeds, the whole-bank index, candidate scan, z-mer matchers
                and the dot-matrix aligner as plain functions on tensors;
                the three streaming kernels (``sseg``, ``jpost``,
                ``pexpand``) launch hand-written CUDA on CUDA tensors and
                take their plain PyTorch version on CPU tensors
- ``csrc``      the CUDA C++ sources (sm_90a)
- ``kernels``   the nvcc build and the ctypes binding
- ``pipeline``  the overlap driver and the dmo ``asm`` driver
- ``cli``       the ``asm`` and ``zmo`` subcommands

- ``data``, ``io``, ``graph``, ``utils``, ``pipeline/pre.py`` and
  ``native/``: copies of the JAX package's host code (read bank, FASTA
  I/O, wtpre, wtclp, wtlay, the native DAG and POA engines, the read
  simulator), held equal to their sources by the tests.

Nothing in this package imports jax or any module of `smartdenovo_tpu`.
"""
