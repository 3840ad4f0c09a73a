"""Hand-written kernels of the port and their plain PyTorch versions.

* ``coherency_step`` — the wrappers of the six coherency-step kernels
  (CUDA C++ in ``csrc/coherency_step.cu``), dispatching by device;
* ``nmp``            — the wrappers of the three near-memory kernels
  (``select_scan``, ``regex_dfa``, ``hash_probe``; ``csrc/nmp.cu``);
* ``models``         — the wrappers of the model substrate's two kernels
  (``flash_attention``, ``rglru_scan``; ``csrc/models.cu``);
* ``ops``            — the near-memory and model kernels' entry points,
  with the reference's padding and routing;
* ``ref``            — the plain PyTorch versions of all eleven;
* ``build``          — compiles ``csrc/*.cu`` with ``nvcc`` at first use.
"""
