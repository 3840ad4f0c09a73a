"""Hand-written kernels of the port and their plain PyTorch versions.

* ``coherency_step`` — the wrappers of the six coherency-step kernels
  (CUDA C++ in ``csrc/coherency_step.cu``), dispatching by device;
* ``ref``            — their plain PyTorch versions;
* ``build``          — compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
