"""ECI's coherency stack in PyTorch, with its step kernels in CUDA.

A port of ``repro`` (the JAX package beside it, which stays the
reference) that mirrors its layout: ``core/`` holds the protocol tables,
the transport, the agents, the sharer-vector directory and the N-remote
engine; ``traffic/`` the streaming driver, its workloads and its
counters; ``nmp/`` the near-memory operators (SELECT, regex, KVS pointer
chase) that ``core/pushdown.py`` runs at the data's home; ``models/``
and ``configs/`` the model substrate's prefill, decode and training loss
for every family of the configs; ``optim/``, ``data/``, ``train/`` and
``checkpoint/`` training (AdamW, the synthetic pipeline, the train step
and ``Trainer``, checkpoints in the reference's format, written and read
with the standard library alone); ``launch/`` and ``runtime/`` meshes
(``torch.distributed`` device meshes with the reference's sharding
rules, the sharded train and serve steps, pipeline stages, elastic
resume, the training and serving drivers); ``kernels/`` the eleven
hand-written kernels — six of the per-step inner plane, three of the
near-memory operators, attention and the RG-LRU scan of the models (CUDA
C++ under ``csrc/``) — beside their plain PyTorch versions.

The package imports ``torch`` and ``numpy`` only — never ``jax`` and
nothing of ``repro``: the protocol tables, the atomic oracle and the
model configs are kept here as copies, so the port runs on a machine
without JAX.

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
