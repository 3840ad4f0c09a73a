"""The benchmark of the PyTorch/CUDA port's coherency engine: sweep
fleets of ``repro_torch.traffic.run_fleet`` on one H100, held bit for bit
against a plain reference.  Run a cell with ``python3 eci_bench/run.py``;
``BENCHMARK.json`` at the checkout's root lists the cells and metrics."""
