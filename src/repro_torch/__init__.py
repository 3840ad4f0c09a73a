"""ECI's coherency stack in PyTorch, with its step kernels in CUDA.

A port of ``repro`` (the JAX package beside it, which stays the
reference) that mirrors its layout: ``core/`` holds the protocol tables,
the transport, the agents, the sharer-vector directory and the N-remote
engine; ``traffic/`` the streaming driver, its workloads and its
counters; ``kernels/`` the four hand-written kernels of the per-step
inner plane (CUDA C++ under ``csrc/``) beside their plain PyTorch
versions.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repro``: the protocol tables and the atomic oracle are kept
here as copies, so the port runs on a machine without JAX.

Every entry point takes ``device=`` and defaults to ``"cuda"``.  On a
CUDA tensor each kernel wrapper launches its kernel or raises; the plain
PyTorch version runs only for tensors on the CPU (``device="cpu"``),
which is how the tests hold the port against ``repro``.

    from repro_torch.traffic import (EngineConfig, StreamConfig,
                                     WorkloadSpec, run_stream, summarize)
    eng = EngineConfig(remotes=64, lines=4096, block=32).build()
    run = run_stream(eng, StreamConfig(workload=WorkloadSpec("zipfian")))
    print(summarize(run.counters, run.msg_count))
"""
from .device import resolve_device  # noqa: F401
