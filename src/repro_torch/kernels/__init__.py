"""Hand-written kernels of the port and their plain PyTorch versions.

* ``coherency_step`` — the wrappers of the six coherency-step kernels
  (CUDA C++ in ``csrc/coherency_step.cu``), dispatching by device;
* ``nmp``            — the wrappers of the three near-memory kernels
  (``select_scan``, ``regex_dfa``, ``hash_probe``; ``csrc/nmp.cu``);
* ``ops``            — the near-memory kernels' entry points, with the
  reference's padding;
* ``ref``            — the plain PyTorch versions of all nine;
* ``build``          — compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
