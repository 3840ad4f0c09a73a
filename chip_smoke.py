#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Runs from the root of a checkout (it imports ``repro_torch`` from
``src/``), needs one CUDA device and ``nvcc``, and imports nothing of JAX
or of the ``repro`` package.  Phases, each of which fails the script:

1. the card's name and power limit; build the CUDA kernels from
   ``src/repro_torch/csrc``, one ``nvcc`` per source, all at once, and
   time the build; print ptxas's report (registers, spills) of the
   tensor-core attention kernel, the RG-LRU scan, ``lat_hist``,
   ``credit_rank``, ``count_fold``, ``regex_dfa`` and ``hash_probe``,
   and the attention kernel's shared memory;
2. each coherency-step kernel against its plain PyTorch version on the
   card, bit-exact (``torch.equal``), at the main path's shapes and at
   edge cases (ragged lengths, storage offsets, a lead axis; for
   ``count_fold`` the running totals ``base``, codes of every kind,
   planes on both sides of its one-CTA size and 1,000 launches back to
   back; for ``packed_any`` one to four planes, strided slices of the
   packed ``[H, 2, L/H, W]`` view and pending arrays among them; for
   ``packed_fanout`` the view's planes in place and the home flags), with
   the kernel's, the plain version's and a one-call PyTorch yardstick's
   device time (the profiler's CUDA trace; ``packed_any`` timed on one
   plane and on phase 6's four, ``packed_fanout`` in the step's form and
   the reference's); ``credit_rank``, ``count_fold``, ``packed_any`` and
   ``packed_fanout`` must each be one device operation per call; and an
   empty kernel on the packed kernels' grids through the same ctypes
   route, the floor a launch-bound kernel cannot go below;
3. the model substrate: ``flash_attention`` (bf16 on the tensor cores,
   fp32 on the CUDA cores) and ``rglru_scan`` against their plain
   versions on the card, allclose (2e-5/2e-2 and 3e-5/3e-2 in
   fp32/bf16), at recurrentgemma-9b's shapes (B=4, S=2048, MQA with 16
   query heads of 256, window 2048, width 4096, bf16), at the cases of
   ``tests/test_kernels.py``, at the edges of the tensor-core kernel's
   tiles and of the scan's chunks (odd D, ragged S, a storage offset, a
   near 1 and near 0), timed beside ``scaled_dot_product_attention``,
   each one device operation per call and timed by its entries
   (``ops_ms``);
   the six supported smoke configs, card against CPU in fp32 (forward and
   12 decode steps at 2e-4, one launch per attention or recurrent block);
   the slice's path: recurrentgemma-9b at its published widths and depth
   in bf16 (parameters drawn on the card), prefill ``forward(last_only=
   True)`` at B=4, S=2048 with exactly 12 and 26 launches per forward
   (and, in its profile, 12 tensor-core flash entries, no CUDA-core
   one and exactly 26 ``rglru_scan`` entries), four requests served as
   ``ServeEngine`` serves them (128-token prompts through
   ``decode_step``, held against the prefill's logits,
   then 32 greedy tokens); a prefill over a prompt that does not tile
   (B=4, S=2000: the plain chunked RG-LRU scan and the dense attention,
   no kernel launched), timed beside the S=2048 one with its device
   operations; and fp32 decode against prefill at 2e-4 at full width
   with depth cut to 5 layers;
4. the near-memory operators at the paper's §5 sizes, through
   ``core.pushdown`` on one shard: SELECT over 4 Mi 128-byte rows and
   regex over 4 Mi rows with a 62-byte string field, each at 1%, 10% and
   100% selectivity, and a KVS of 65,536 buckets at chain lengths 1, 8,
   32 and 128 under 1 Mi queries — each run checked against its oracle
   (the predicate, python ``re``, the plain lookup), each call launching
   its kernel exactly once, the regex reading its string field in place
   and the lookup chasing build_sharded_kvs's records (every entry of
   one regex call is printed); ``select_scan``, ``regex_dfa`` and
   ``hash_probe`` held against their plain versions bit for bit on the
   path's data and on edge cases (strided and unaligned fields, both KVS
   layouts), timed, with a bound fixed per kernel (10% selectivity,
   chain 32): ``regex_dfa`` on the field in place and on a contiguous
   copy, ``hash_probe`` on records and on two arrays, each one device
   operation per call but the two arrays' (an interleave, then the
   kernel);
5. the main path: the device operations and device time of one dense
   step from the profiler (``step_profile``); ``run_stream`` on zipfian
   traffic at R=64 remotes,
   L=4096 lines of B=32 fp32 words (128-byte lines), MOESI, issue width
   W=1 at 16 ops per remote (``W1_OPS``) and W=4 at 16 (``W4_OPS``),
   each with the default step budget for its ops and validated by the
   port's own ``validate_run`` against its own ``MultiNodeRef``, with the
   launch count of every kernel in that run;
6. small streams (L=16, B=4) on the card through the kernels and on the
   CPU through the plain versions — dense R=8 MESI and MOESI, packed
   two-home R=33 MESI and R=64 MOESI, two homes with ``home_bw=1``,
   shared credits, and open-loop and observed streams (Poisson arrivals
   with the admission cap, bursty arrivals, a packed two-home stream
   under admission, an observed stream with an injected request):
   counters, message counts, retirement trace, sojourn and
   admission-wait histograms, backlog and the observability digest
   (words, verdicts, phase histograms) bit-identical, and each packed run
   equal to the dense run of the same configuration;
7. the packed two-home path at the main path's width: ``EngineConfig(
   remotes=64, lines=4096, block=32, homes=2, packed=True)``, MOESI,
   zipfian, W=1, 16 ops per remote (``PACKED_OPS``): the device
   operations, device time and step-kernel entries of one packed step
   (``step_profile(packed=True)``), then the run, validated against the
   two-home oracle, with its own launch table (``packed_any`` 4 and
   ``packed_fanout`` 1 per step, run only here) and the
   directory-state bytes of both layouts;
8. open loop and observation at the main path's width (R=64, L=4096,
   B=32, MOESI, dense, W=1): the device operations and host wall time of
   one step under the admission loop and under the observability plane
   (``step_profile(mode=...)``); no host synchronisation in either loop;
   Poisson arrivals at 0.01 ops/step/remote (``SOJ_RATE``, seed 1) with
   ``ADMISSION``, 2 ops per remote and the auto budget, which must
   complete oracle-exact with no backlog and ``PER_STEP`` launches per
   step, its sojourn and admission-wait percentiles printed; the same at
   0.05 (``OVERLOAD_RATE``, 8 ops) over the arrival span, which must end
   with a backlog; an observed run (2 ops per remote, ``OBS_CAPACITY`` words)
   equal bit for bit to the plain run, with no violation online or in
   ``check_trace`` over its ring; and a request injected into an open
   request window, which must be latched at its (step, line) and flagged
   by ``check_trace``;
9. fleets and the command line (R=64, L=4096, B=32, MOESI, zipfian,
   ``FLEET_OPS`` ops per remote): the device operations and host wall
   time of one step of each fleet beside the dense step's
   (``step_profile(mode="grid"|"homes")``); no host synchronisation in
   the member-batched loop; an R x W grid fleet (``FLEET_GRID``) and a
   homes fleet (H in ``FLEET_HOMES`` at R=64, ``home_bw=1``, credits
   4,096) through ``run_fleet``, ``PER_STEP`` launches per fleet step,
   every member oracle-validated and two members of each bit-identical
   to their solo ``run_stream``, with member-steps/s against the solo
   runs' wall time; a small fleet (R <= 8, L=16) card against CPU; the
   grouped ``count_fold`` timed at the grid's ``[4, 64, 4096]``; the
   command line's ``--smoke`` on the card (every case PASS) and one run at
   R=64, L=4096 whose ``--artifacts`` config.json, read back through
   ``--config``, prints the same summary;
10. the two-node store and the serving tier: the rounds of one two-node
   ``Engine.run_ops`` at L=4096, B=32 with its launches per step,
   device operations and host wall per round; ``CoherentStore(
   n_remotes=1)`` at L=4096, B=32 for FULL_MOESI, ENHANCED_MESI,
   READ_ONLY and STATELESS (reads, re-reads, writes, evicts, a
   ``home_read`` of dirty lines, ``home_write`` of uncached ones, an
   operator's virtual blocks read, evicted and read again, the operator
   run once), card == CPU on every state leaf, value and count, with
   ``TWO_NODE_PER_STEP`` launches per step; the N-remote store's write
   fan-out at R=64 over ``FANOUT_LINES`` lines, exactly 63 ×
   ``FANOUT_LINES`` ``HOME_DOWNGRADE_I`` as ``MultiNodeRef`` counts per
   line, card == CPU at R=8, L=256; ``CoherentPrefixTier`` with 1 and 4
   readers over recurrentgemma-9b's ``ServeEngine`` in bf16 (B=4, 128-token
   prompts, 32 new tokens): a hot request's tokens equal to the cold
   one's, a republish invalidating exactly the readers holding the line;
   ``quantize_params`` on the card (one weight of each shape bit for bit
   against the CPU) and the int8 engine's decode rate and token agreement;
11. the model families (MoE, RWKV6, encoder-decoder): the smoke configs
   of granite-moe (also with ``dispatch_int8``), qwen3-moe, rwkv6 and
   whisper card against CPU in fp32 (forward and 12 decode steps at
   2e-4; one ``flash_attention`` per attention block, the encoder's and
   the cross blocks among them: whisper 6, 4 of them non-causal, rwkv6
   none); granite-moe-1b-a400m (24 layers, B=4, S=2048), rwkv6-3b (32
   layers, B=4, S=2048) and whisper-small (12 + 12 layers, B=4, 1500
   frames, 256 tokens) at their published widths in bf16, one at a time
   with parameters drawn on the card: prefill tokens/s (best of 3), with
   exactly 24, 0 and 12 tensor-core ``flash_attention`` launches a
   forward, four requests served through ``decode_step`` (whisper's cross
   K/V computed once) and 32 greedy tokens, the bf16 decode/prefill gap
   printed, and the device split of one granite-moe prefill (MoE
   dispatch, expert bmm, attention); ``flash_attention`` at granite-moe's
   [4, 16, 2048, 64] beside ``scaled_dot_product_attention``; fp32 at
   full width with 2 layers, decode against prefill at 2e-4 (MoE at
   capacity 8.0); one granite-moe layer in fp32 over 8,192 tokens, card
   against CPU (``dispatch_positions`` bit for bit, the output at 2e-4,
   the dropped slots printed);
12. training on one device (``use_kernel=False``, as the reference's
   ``loss_fn``; no kernel on this path, and none launched): the model
   kernels refuse a CUDA input that requires grad; card against CPU in
   fp32 with TF32 off, at the CPU tests' tolerances: ``loss_fn``'s loss
   and every gradient leaf of the ten smoke configs and of smollm-360m at
   full width cut to 2 layers (B=2, S=512), one AdamW update on the same
   gradients, the int8 MoE wire's backward bit for bit and the int8
   smoke model's gradients; ``Trainer`` on the card cut by
   ``fail_at`` and resumed from its checkpoint, bit-identical to an
   uninterrupted run; smollm-360m whole in bf16 with full remat on
   ``SyntheticPipeline`` batches of 16 x 4096 tokens as two
   micro-batches: a warm-up and three steps of ``train_step`` (loss, grad
   norm, lr, s a step, tokens/s, the device's idle share, peak memory;
   within ``TRAIN_BUDGET_S``; the peak below ``TRAIN_PEAK_BEFORE``,
   that of a backward keeping every attention tile), then the whole
   ``TrainState`` saved, verified and loaded back on the card bit for
   bit (bytes and seconds); recurrentgemma-9b at its published widths,
   one superlayer (rg, rg, la), bf16, B=1 x 4096: a warm-up and one
   timed ``train_step`` (s, tokens/s, peak, the aten operations of one
   RG-LRU scan call, no kernel launched);
13. meshes, on a one-device NCCL world (``make_local_mesh``, shapes
   (1, 1) and (1, 1, 1); every collective of a world of one is a copy,
   and the tensor-parallel model code on a group of one runs the
   unsharded code, so each sharded path equals its unsharded twin bit
   for bit):
   smollm-360m whole in bf16, ``make_train_step`` in ``"2d"`` and
   ``"fsdp"`` against ``train_step`` from the same state over two steps of
   B=4, S=1024 (loss, grad norm and every leaf; the step times printed);
   ``make_serve_step`` against ``decode_step`` over 32 greedy tokens at
   B=4 (logits); ``filtered_batch`` against ``pushdown_select`` over 1 Mi
   128-byte rows at 10%, ``select_scan`` launched once a call;
   ``compressed_psum`` and ``pipeline_apply`` on a group of one against
   their closed forms; ``resume_on_mesh`` of a 2-layer full-width
   ``TrainState`` checkpoint; ``python -m repro_torch.launch.train`` and
   ``launch.serve`` (smoke) as subprocesses, exit 0; the process group is
   destroyed at the phase's end.
14. the roofline (``repro_torch.roofline``), no kernel: the analytic
   roofline at the H100's rates of all 80 (arch x shape x mesh) records,
   single pod (16, 16) and multi-pod (2, 16, 16), as a table; the
   analytic bound on one device (``MeshDesc(1, 1)``) beside this run's
   own measured steps: phase 12's smollm-360m train step (16 x 4096) and
   phase 3's recurrentgemma-9b prefill (B=4, S=2048), t_compute,
   t_memory and the measured time; one production-mesh dry-run cell,
   ``python -m repro_torch.launch.dryrun`` on a fake 256-rank world, run
   as a subprocess with no CUDA device visible (started before phase 12,
   so that it overlaps phases 12 and 13), its record ``ok`` with 256
   chips, its wall time beside ``DRYRUN_BUDGET_S``.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or outside a checkout, it exits non-zero and prints neither.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: HBM rate of an H100 SXM (NVIDIA data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (NVIDIA data sheet), used as the
#: rate of the kernels' 32-bit integer operations.
CUDA_CORE_OPS_PER_S = 67e12
#: bf16 dense tensor-core rate of an H100 SXM (NVIDIA data sheet): the
#: least time attention's products could take on this card.
TENSOR_CORE_FLOPS_PER_S = 989e12

R, L, B, P = 64, 4096, 32, 65
#: ops per remote of the dense W=1 and W=4 runs and of the packed
#: two-home W=1 run, cut from the ``WorkloadSpec`` default of 128 so that
#: the script keeps a margin under its 1200 s limit on a slow host (see
#: PERF.md, section 4; the packed run cut again from 64 when phase 10
#: came in; when phase 13 came in, W=1 from 64 and W=4 and the packed
#: run from 32, after whole runs took 1220.1 and 1207.6 s on slow hosts;
#: W=1 from 24 when phase 12 (e) and phase 3's ragged prefill came in).
W1_OPS = 16
W4_OPS = 16
PACKED_OPS = 16

#: phase 8, open loop and observation at the main path's width: Poisson
#: arrivals at 0.01 ops/step/remote (about 47% of the closed loop's
#: capacity here, 0.0213) and at 0.05 (about 2.3 times it), 2 ops per
#: remote below the knee (16 before phase 12 came in, 8 before phase 13;
#: PERF.md section 4) and 8 past it (at 4 the arrival span ended with no
#: backlog on an H100), the admission cap (max_inflight, reserve) of the
#: reference's knee at R=8, (16, 2), scaled by R; the observed run at 2
#: ops per remote (8 before phase 12, 4 before phase 13) into a ring of
#: 65,536 words.
SOJ_RATE, OVERLOAD_RATE, OPEN_OPS, OVERLOAD_OPS = 0.01, 0.05, 2, 8
ADMISSION = (128, 16)
OBS_OPS, OBS_CAPACITY = 2, 1 << 16

#: the packed two-home path: homes, words per line at R=64.
HOMES, NW = 2, 2

#: phase 9, fleets at the main path's width: 1 op per remote (2 before
#: phase 13 came in, 4 before phase 12, 8 before phase 10), an R x W grid
#: and a homes sweep at R=64 with a per-home acceptance cap of 1; credits
#: of 4,096 a VC, since the fleet's home emulation is exact only while
#: credits cover the lines.
FLEET_OPS = 1
FLEET_GRID = ((16, 1), (16, 4), (64, 1), (64, 4))
FLEET_HOMES, FLEET_HOME_BW, FLEET_CREDITS = (1, 2, 4), 1, 4096

#: the near-memory phase, at a quarter of the rows of the paper's §5 (16
#: Mi before phase 12 came in, 8 Mi before phase 13; PERF.md §4): SELECT
#: over 4 Mi rows of 32 fp32 (128-byte rows, 512 MiB) and regex over 4 Mi
#: rows of 128 bytes with a 62-byte string field, each at three
#: selectivities; a KVS of 65,536 buckets at four chain lengths, 1 Mi
#: queries with about 11% misses (keys 1..n, queries in [1, 1.125 n)).
NMP_ROWS, SEL_W = 4_194_304, 32
SELECTIVITIES = (0.01, 0.1, 1.0)
REGEX_W, STR_LO, STR_HI, PATTERN = 128, 8, 70, "xyzzy"
KVS_BUCKETS, KVS_QUERIES, V_WIDTH, MISS = 65_536, 1_048_576, 28, 0.125
CHAINS = (1, 8, 32, 128)
#: the one selectivity and chain length each kernel's bound is taken at.
BOUND_SEL, BOUND_CHAIN = 0.1, 32
#: pushdown calls per run (the best is reported) and timed kernel calls.
NMP_REPS, NMP_ITERS = 3, 20

#: the model phase: recurrentgemma-9b, the one config whose path runs
#: both model kernels, at its published widths and depth in bf16;
#: prefill of B=4 sequences of S=2048 (its window); four requests of
#: 128-token prompts and 32 new tokens; the fp32 exactness check at full
#: width with depth cut to 5 layers, over S=128.
MODEL, PREFILL_B, PREFILL_S, WINDOW, WIDTH = ("recurrentgemma-9b", 4, 2048,
                                              2048, 4096)
PROMPT, NEW_TOKENS, EXACT_S = 128, 32, 128
#: a prompt length that does not tile (not a multiple of 128): the
#: prefill takes the plain RG-LRU scan and the dense attention.
RAGGED_S = 2000
#: the bf16 gap between decode and prefill logits over 38 layers is a
#: measured quantity: 0.2734 on an H100 (PERF.md, section 6), bounded at
#: twice that.  The top-1 agreement is printed, not held: with random
#: weights the top logits of 256,000 lie closer together than the gap.
BF16_GAP_BOUND = 0.55
#: the smoke configs held card against CPU: the decoders of phase 3, then
#: the families of phase 11 (MoE, RWKV6, encoder-decoder).
SMOKE_ARCHS = ("smollm-360m", "gemma2-9b", "granite-34b", "nemotron-4-340b",
               "chameleon-34b", "recurrentgemma-9b", "granite-moe-1b-a400m",
               "qwen3-moe-235b-a22b", "rwkv6-3b", "whisper-small")
FAMILY_ARCHS = SMOKE_ARCHS[6:]
#: phase 11, the model families at their published widths in bf16, one
#: at a time: (config, prefill batch, prefill tokens).  granite-moe at all
#: 24 layers and rwkv6-3b at all 32 (its time mix a chunked scan,
#: ``models/rwkv6.py::wkv_chunked``), both at S=2048; whisper-small's
#: 12 + 12 layers over its 1500 frames and 256 tokens.  Each then serves
#: ``PREFILL_B`` requests of ``PROMPT`` tokens and ``NEW_TOKENS`` more.
FAMILY_PATHS = (("granite-moe-1b-a400m", 4, 2048), ("rwkv6-3b", 4, 2048),
                ("whisper-small", 4, 256))
#: phase 11's fp32 exactness check: full width, 2 layers (whisper 2
#: encoder and 2 decoder layers), decode against prefill over
#: ``FAMILY_EXACT_S`` tokens; MoE at capacity 8.0, which drops no slot.
FAMILY_EXACT_LAYERS, FAMILY_EXACT_S = 2, 64
#: phase 11's MoE layer card against CPU: one granite-moe layer in fp32
#: over T tokens (a B=4, S=2048 prefill's).
MOE_LAYER_T = 8192
#: card against CPU with the int8 dispatch and combine: rounding to a code
#: is discontinuous, so an fp32 value within an ulp of a half code (the
#: products' order differs between the card and the CPU) rounds one way
#: there and the other here, moving a slot by one code, 1/127 of its
#: row's largest value (0.0077 in the logits on an H100, PERF.md
#: section 6); the smoke configs' other cases hold at 2e-4.
Q8_TOL = 2e-2
#: phase 11's budget: printed beside its wall time.
FAMILY_BUDGET_S = 120
#: phase 12, training on one device: smollm-360m whole (32 layers,
#: d=960, bf16, full remat) on ``SyntheticPipeline`` batches at
#: ``train_4k``'s S=4096, global batch 16 (cut from train_4k's 256 for the
#: phase's time, PERF.md section 4) as two micro-batches of 8; a warm-up
#: step, then ``TRAIN_STEPS`` timed steps, which must fit in
#: ``TRAIN_BUDGET_S`` (printed beside the phase's wall time).
TRAIN_ARCH, TRAIN_S, TRAIN_BATCH, TRAIN_MICRO, TRAIN_STEPS = (
    "smollm-360m", 4096, 16, 2, 3)
TRAIN_BUDGET_S = 90
#: phase 12's step before each query block of the plain attention was
#: recomputed in the backward (PERF.md section 5): its peak in
#: bytes, held as a ceiling, and its step seconds, printed beside.
TRAIN_PEAK_BEFORE, TRAIN_STEP_BEFORE = 34_966_835_712, (16.113, 17.407)
#: phase 12 (e), a hybrid model trains: recurrentgemma-9b at its
#: published widths, depth cut to one superlayer (rg, rg, la; 3 of 38
#: layers, the tail dropped; PERF.md section 4), bf16, its config's
#: remat, one micro-batch of B x S: a warm-up step and one timed step;
#: ``HYBRID_BUDGET_S`` is printed beside its wall time.
HYBRID_B, HYBRID_S, HYBRID_BUDGET_S = 1, 4096, 30
#: phase 12's card-against-CPU tolerances, fp32 with TF32 off: the CPU
#: tests' own (``tests/test_torch_train.py``): the loss within 1e-5,
#: every gradient leaf at atol 1e-5 and rtol 1e-4; one AdamW update's
#: parameters at 1e-6/1e-5, moments at 1e-7/1e-5 (m) and 1e-9/1e-5 (v).
LOSS_TOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-5, 1e-4
#: smollm-360m at full width cut to 2 layers, fp32, B=2 over S=512.
TRAIN_EXACT_LAYERS, TRAIN_EXACT_B, TRAIN_EXACT_S = 2, 2, 512
#: phase 13, meshes on a one-device NCCL world: smollm-360m whole in bf16,
#: ``MESH_STEPS`` sharded train steps of B x S in each mode against the
#: unsharded step; ``MESH_TOKENS`` greedy tokens of the sharded serve step
#: at B; ``filtered_batch`` over ``MESH_ROWS`` 128-byte rows at
#: ``MESH_SEL``; ``resume_on_mesh`` of a ``MESH_RESUME_LAYERS``-layer
#: full-width ``TrainState``.  ``MESH_BUDGET_S`` is printed beside the
#: phase's wall time.
MESH_ARCH, MESH_B, MESH_S, MESH_STEPS, MESH_TOKENS = (
    "smollm-360m", 4, 1024, 2, 32)
MESH_ROWS, MESH_SEL, MESH_RESUME_LAYERS, MESH_BUDGET_S = 1 << 20, 0.1, 2, 60
#: phase 14, the roofline: one production cell through the dry run's
#: CLI on a fake 256-rank world (35-45 s of one CPU core, PERF.md
#: section 5); ``DRYRUN_BUDGET_S`` is printed beside its wall time.
DRYRUN_ARCH, DRYRUN_SHAPE, DRYRUN_MESH, DRYRUN_BUDGET_S = (
    "smollm-360m", "decode_32k", "single", 90)
#: the cases of ``tests/test_kernels.py``: (B, Hq, Hkv, Sq, Sk, D, causal,
#: window, softcap) and (B, S, D), with its tolerances per dtype.
ATTN_CASES = ((2, 4, 2, 64, 64, 32, True, None, None),
              (1, 4, 1, 32, 64, 16, True, None, None),
              (1, 2, 2, 64, 64, 32, True, 16, None),
              (1, 2, 2, 64, 64, 32, True, None, 30.0),
              (1, 2, 2, 64, 64, 32, False, None, None),
              (1, 3, 3, 1, 64, 32, True, None, None))
#: the edges of the tensor-core kernel's tiles (128 queries, 64 keys):
#: ragged lengths at the head dims 256, 128 and 16, MQA with a softcap,
#: one query over a ragged cache, a window shorter than a tile.
TC_EDGE_CASES = ((2, 16, 1, 320, 320, 256, True, 100, 30.0),
                 (1, 4, 2, 1, 300, 128, True, None, None),
                 (1, 2, 2, 200, 200, 16, False, 50, None),
                 (1, 2, 1, 130, 130, 64, True, 32, None))
RGLRU_CASES = ((2, 64, 32), (1, 128, 64), (3, 32, 16))
#: the edges of the chunked scan (64 channels a CTA; chunks of 16 steps in
#: bf16 and 8 in fp32, 16 chunks a super-chunk): odd D, S below one
#: chunk, S not a multiple of a super-chunk, D not a multiple of 64.
RGLRU_EDGE_CASES = ((1, 33, 7), (2, 5, 64), (2, 300, 128), (3, 70, 66))
#: kernels the ``rglru_scan`` wrapper launches per call.
RGLRU_KERNELS_PER_CALL = 1
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
RGLRU_TOL = {"float32": 3e-5, "bfloat16": 3e-2}
#: the tensor-core attention kernel's dynamic shared memory at D=256, as
#: ``Tile<256>::SMEM`` in ``csrc/models.cu``: 1024 bytes of alignment, Q
#: (128 x 256 bf16), two K and two V stages (64 x 256 bf16), 9 mbarriers.
TC_SMEM_D256 = 1024 + 2 * 128 * 256 + 4 * 2 * 64 * 256 + 9 * 8
#: timed calls of each model kernel (one attention call takes milliseconds).
MODEL_ITERS = 10

#: the Pallas kernel each CUDA kernel replaces (file:line of pallas_call).
REPLACES = {
    "credit_rank": "src/repro/kernels/coherency_step.py:99",
    "arb_winner": "src/repro/kernels/coherency_step.py:144",
    "count_fold": "src/repro/kernels/coherency_step.py:193",
    "lat_hist": "src/repro/kernels/coherency_step.py:234",
    "packed_any": "src/repro/kernels/coherency_step.py:269",
    "packed_fanout": "src/repro/kernels/coherency_step.py:320",
    "select_scan": "src/repro/kernels/select_scan.py:62",
    "regex_dfa": "src/repro/kernels/regex_dfa.py:56",
    "hash_probe": "src/repro/kernels/hash_probe.py:66",
    "flash_attention": "src/repro/kernels/flash_attention.py:114",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:57",
}
#: launches per engine step on the main path (dense, one home).
PER_STEP = {"credit_rank": 2, "arb_winner": 1, "count_fold": 5,
            "lat_hist": 1, "packed_any": 0, "packed_fanout": 0}
#: launches per engine step on the packed two-home path: absorb's
#: no-sharers test in phases 2 and 3, the pending test in phase 4 and
#: the grant-precondition test of phase 6 (one launch over the two
#: fan-out planes and the two pending planes) are ``packed_any``; the
#: fan-out words of phase 5, the home side's among them, are
#: ``packed_fanout``.
PACKED_PER_STEP = {"credit_rank": 2, "arb_winner": 1, "count_fold": 5,
                   "lat_hist": 1, "packed_any": 4, "packed_fanout": 1}
#: phase 10, the two-node store and the serving tier: (a) a
#: ``CoherentStore(n_remotes=1)`` program at the main path's plane (L
#: lines of B fp32) for each subset, card against CPU, with
#: ``VIRTUAL_BLOCKS`` virtual blocks read through an operator; (b) the
#: N-remote store's write fan-out at R=64 over ``FANOUT_LINES`` lines
#: (cut from the main path's 4,096 to keep the phase near its 90 s: 64
#: reads of every line took 42.4-42.9 s at 4,096, see PERF.md section
#: 4), card against CPU at ``SMALL_FANOUT`` = (R, L); (c)
#: ``CoherentPrefixTier`` with each of ``TIER_READERS`` readers over
#: recurrentgemma-9b's ``ServeEngine``: ``PREFILL_B`` prompts of
#: ``PROMPT`` tokens, ``NEW_TOKENS`` new, in bf16 and int8.  A VC's
#: credits (64) cap the messages in flight, so a store call over
#: thousands of lines takes tens of rounds: ``STORE_ROUNDS`` is every
#: store's ``max_rounds`` here.
STORE_SUBSETS = ("full_moesi", "enhanced_mesi", "read_only", "stateless")
VIRTUAL_BLOCKS = 64
STORE_ROUNDS = 4096
FANOUT_LINES = 1024
SMALL_FANOUT = (8, 256)
TIER_READERS = (1, 4)
#: launches per two-node step: ``credit_rank`` for the dry run of
#: ``stall_unready_ops``, the remote's request submit and the home's
#: downgrade submit; ``count_fold`` for the four delivered-message folds.
TWO_NODE_PER_STEP = {"credit_rank": 3, "arb_winner": 0, "count_fold": 4,
                     "lat_hist": 0, "packed_any": 0, "packed_fanout": 0}
#: launches per N-remote step of a store: ``step_mn`` alone (the latency
#: histogram belongs to ``run_stream``'s counters).
STORE_MN_PER_STEP = dict(PER_STEP, lat_hist=0)
#: the CUDA source of each kernel.
SOURCES = dict.fromkeys(PER_STEP, "src/repro_torch/csrc/coherency_step.cu")
SOURCES.update(dict.fromkeys(("select_scan", "regex_dfa", "hash_probe"),
                             "src/repro_torch/csrc/nmp.cu"))
SOURCES.update(dict.fromkeys(("flash_attention", "rglru_scan"),
                             "src/repro_torch/csrc/models.cu"))


def ptxas_summary(report: str, kernel: str):
    """One line per instantiation of ``kernel`` in ptxas's ``-v`` report:
    its registers, shared memory, stack and spills, and any note that
    ptxas serialised its wgmmas (C75xx).  Nothing when the library was
    already built."""
    out, cur, name = [], None, ""
    for line in report.splitlines():
        if "Compiling entry function" in line:
            cur = [] if kernel in line else None
            name = line.split("'")[1] if cur is not None else ""
            if cur is not None:
                out.append((name, cur))
        elif "Potential Performance Loss" in line and kernel in line:
            out.append((kernel, [line.split("info    :")[-1].strip()]))
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.replace("ptxas info    :", "").strip())
    return [instance(n) + "; ".join(c) for n, c in out]


def instance(name: str) -> str:
    """A kernel's template arguments from its mangled name, as a prefix:
    the head dim of an attention kernel, the dtype and load width of the
    scan, the threads of a CTA of the others; nothing for a kernel that is
    no template."""
    if "ILi" in name:
        arg = name.split('ILi')[-1].split('E')[0]
        return (f"D={arg}: " if "flash_attention" in name
                else f"{arg} threads: ")
    if "regex_dfa_smem_kernel" in name:
        return "TMA: " if "ILb1E" in name else "cp.async: "
    if "rglru_scan_kernel" in name:
        return (("bf16" if "bfloat16" in name else "fp32")
                + (", pairs: " if "Lb1E" in name else ", one at a time: "))
    return ""


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def wall_ms(fn, iters: int = 200, warmup: int = 10) -> float:
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: the device's time including any gaps in which
    it waits for the host to launch the next call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: profiling windows tried before a window with no device time fails.
PROFILE_TRIES = 3


def engine_steps(fn):
    """``fn()`` and the engine steps its loop ran, the calls of the
    ``engine.step`` span (host mode): the loop stops once the run is
    quiet, so a budget past quiescence runs fewer steps than it counts."""
    from repro_torch import spans
    spans.reset()
    spans.enable()
    try:
        out = fn()
    finally:
        spans.disable()
    ran = spans.summary().get("engine.step", {"calls": 0})["calls"]
    spans.reset()
    return out, ran


def device_entries(fn, iters: int = 100, required: bool = True):
    """The profiler's device entries (kernels and memsets) over ``iters``
    calls of ``fn``, after one call to warm up.  Only device entries
    count: the entry of an aten op also carries the time of the kernels
    it launched, which have entries of their own.  A window in which the
    profiler recorded no device time at all (seen once on an H100 for a
    kernel that records in every other run, and for every window late in
    a whole run of this script) is profiled again, up to
    ``PROFILE_TRIES`` windows; then the script fails, or, unless
    ``required``, None is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        on_card = [ev for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA]
        if sum(ev.self_device_time_total for ev in on_card) > 0:
            return on_card
        print(f"profiler: no device time recorded in window {attempt} of "
              f"{PROFILE_TRIES}")
    if required:
        fail("the profiler recorded no device time")
    return None


def device_ms(fn, iters: int = 100):
    """(mean device time per call of ``fn`` in ms, device operations per
    call): the summed durations of the kernels and memsets it runs, from
    the profiler's CUDA trace."""
    on_card = device_entries(fn, iters)
    total_us = sum(ev.self_device_time_total for ev in on_card)
    return total_us / iters / 1e3, sum(ev.count for ev in on_card) / iters


def per_call(on_card, iters: int):
    """[(name, runs per call, ms per call)] of the device entries of
    ``iters`` calls, longest first.  The profiler's CUDA trace drops some
    records of long kernels launched through ctypes (0.67-0.95 of them
    kept per call, seen on an H100), so a sum over the calls comes
    short: an entry's runs per call are its count over the calls,
    rounded, at least 1, each at the mean duration of those recorded."""
    rows = []
    for ev in on_card:
        runs = max(1, round(ev.count / iters))
        rows.append((ev.key, runs,
                     runs * ev.self_device_time_total / ev.count / 1e3))
    return sorted(rows, key=lambda r: -r[2])


def where_the_time_goes(label: str, fn, wall_s: float, iters: int = 3,
                        top=4, required: bool = True):
    """Print the device time of one call of ``fn`` (``per_call``) against
    its wall time (the device's idle share) and its ``top`` longest device
    entries (``None``: every entry, with its runs per call).  Unless
    ``required``, a profiler that records no device time is reported, not
    failed (``device_entries``)."""
    on_card = device_entries(fn, iters, required)
    if on_card is None:
        print(f"{label}: device time not measured (the profiler recorded "
              f"none)")
        return
    rows = per_call(on_card, iters)
    total = sum(ms for _, _, ms in rows)
    ops = sum(runs for _, runs, _ in rows)
    entries = "; ".join(f"{key[:48]} {ms:.3f} ms"
                        + ("" if top else f" x{runs}")
                        for key, runs, ms in rows[:top])
    print(f"{label}: device {total:.3f} ms in {ops} ops of "
          f"{wall_s * 1e3:.3f} ms wall (idle "
          f"{100 * (1 - total / (wall_s * 1e3)):.1f}%); "
          f"{'longest' if top else 'every entry'}: {entries}")


def ops_ms(label: str, fn, iters: int, ops_per_call: int, own: str):
    """(device ms per call, device operations per call) of ``fn``, failing
    unless each call runs ``ops_per_call`` device operations, each once
    and one of them named ``own``: the distinct device entries of
    ``iters`` calls, each recorded at most ``iters`` times (``per_call``:
    the profiler may drop records, never add them)."""
    on_card = device_entries(fn, iters)
    names = [ev.key for ev in on_card]
    if len(on_card) != ops_per_call or not any(own in k for k in names) \
            or any(ev.count > iters for ev in on_card):
        seen = [(ev.key[:48], ev.count) for ev in on_card]
        fail(f"{label}: device entries {seen} over {iters} calls, "
             f"expected {ops_per_call} a call, one of them {own}")
    kept = min(ev.count for ev in on_card)
    if kept < iters:
        print(f"profiler: {label}: {kept} of {iters} records kept")
    return sum(ms for _, _, ms in per_call(on_card, iters)), ops_per_call


def max_abs_err(got, want) -> int:
    import torch
    if got.shape != want.shape:
        fail(f"shape {tuple(got.shape)} != {tuple(want.shape)}")
    if got.numel() == 0:
        return 0
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def bits(t):
    """A float tensor as the integers of its bits (so ``-0.0`` and ``+0.0``
    differ and a NaN equals itself); other tensors as they are."""
    import torch
    if t.is_floating_point():
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])
    return t


def dtype_name(t) -> str:
    return str(t.dtype).removeprefix("torch.")


def record_kernel(rows, name, check_cases, kernel, plain, library, nbytes,
                  nops, iters=100, tol=None, ops_rate=CUDA_CORE_OPS_PER_S,
                  ops_per_call=None):
    """Hold ``kernel``'s results against its plain version's on every
    ``(what, got, want)`` case — bit for bit, or, with ``tol`` (a
    tolerance per dtype), allclose at the tolerance of ``got``'s dtype —
    then time the kernel, the plain version and the library call
    (``None``: no one PyTorch call computes the function) at the path's
    shape, and add the kernel's row to ``rows`` with its bound: ``nbytes``
    at the HBM rate or ``nops`` at ``ops_rate``, whichever is longer;
    with ``ops_per_call``, fail unless the kernel's call runs exactly
    that many device operations, its own among them (``ops_ms``, which
    also gives the kernel's time)."""
    import torch
    err = 0
    for what, got, want in check_cases:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if tol is None:
            same = all(a.shape == b.shape and torch.equal(bits(a), bits(b))
                       for a, b in zip(got, want))
            e = max(max_abs_err(bits(a).reshape(-1), bits(b).reshape(-1))
                    for a, b in zip(got, want))
        else:
            same = all(a.shape == b.shape and torch.allclose(
                a.float(), b.float(), atol=tol[dtype_name(a)],
                rtol=tol[dtype_name(a)])
                for a, b in zip(got, want))
            e = max(float((a.float() - b.float()).abs().max())
                    if a.shape == b.shape else float("inf")
                    for a, b in zip(got, want))
        if not same:
            fail(f"{name} differs from its plain version ({what}), "
                 f"max abs err {e}")
        err = max(err, e)
    ms, n_ops = device_ms(kernel, iters) if ops_per_call is None else \
        ops_ms(name, kernel, iters, ops_per_call, name)
    plain_ms, plain_ops = device_ms(plain, iters)
    lib_ms, lib_ops = (device_ms(library, iters) if library is not None
                       else (None, 0))
    call_ms = wall_ms(kernel, iters)
    bound_b = nbytes / HBM_BYTES_PER_S * 1e3
    bound_o = nops / ops_rate * 1e3
    rows[name] = {
        "name": name, "route": "cuda", "source": SOURCES[name],
        "replaces": REPLACES[name], "launches": 0,
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(bound_b, bound_o),
        "bound_by": "bytes" if bound_b >= bound_o else "operations",
        "library_ms": lib_ms}
    print(f"kernel {name}: "
          f"{'bit-exact' if tol is None else 'allclose'} on "
          f"{len(check_cases)} cases (max abs err {err:g}); "
          f"device {ms * 1e3:.3f} us in {n_ops:g} ops (plain "
          f"{plain_ms * 1e3:.3f} us in {plain_ops:g}, library "
          f"{'-' if lib_ms is None else f'{lib_ms * 1e3:.3f}'} us in "
          f"{lib_ops:g}, bound {max(bound_b, bound_o) * 1e3:.3f} us); "
          f"{call_ms * 1e3:.2f} us per call back to back")


def phase_kernels(dev):
    """Phase 2: every coherency-step kernel against its plain version;
    timings."""
    import torch
    from repro_torch.kernels import coherency_step as K
    from repro_torch.kernels import ref

    g = torch.Generator(device="cpu").manual_seed(12)

    def rand_bool(shape, p):
        return (torch.rand(shape, generator=g) < p).to(dev)

    rows = {}

    def record(name, check_cases, kernel, plain, library, nbytes, nops,
               **kw):
        record_kernel(rows, name, check_cases, kernel, plain, library,
                      nbytes, nops, **kw)

    def view_at(t, off):
        """A contiguous copy of ``t`` that starts ``off`` elements past
        the start of its storage."""
        v = torch.zeros(t.numel() + off, dtype=t.dtype,
                        device=dev)[off:].view(t.shape)
        return v.copy_(t)

    # -- credit_rank: [R, L] bool planes (the two credited submits) -------
    act = rand_bool((R, L), 0.4)
    cnd = rand_bool((R, L), 0.3) & ~act
    cases = [("R=64 L=4096", K.credit_rank(act, cnd),
              ref.credit_rank_ref(act, cnd))]
    for shape, pa, pc in (((5, 4097), 0.4, 0.3), ((3, 33), 0.5, 0.5),
                          ((R, L), 0.0, 0.0), ((1, 1), 1.0, 0.0),
                          ((R, L - 1), 0.4, 0.3), ((HOMES, R, L), 0.4, 0.3),
                          ((3, 9000), 0.4, 0.3), ((R, L), 1.0, 0.0)):
        a, c = rand_bool(shape, pa), rand_bool(shape, pc)
        cases.append((f"{shape}", K.credit_rank(a, c),
                      ref.credit_rank_ref(a, c)))
    # storage offsets: 1 byte (an odd start, both planes on one phase),
    # and 1 and 2 bytes (no common alignment: every lane one at a time)
    for a_off, c_off in ((1, 1), (1, 2), (15, 15)):
        a, c = view_at(act, a_off), view_at(cnd, c_off)
        cases.append((f"storage offsets {a_off} B, {c_off} B",
                      K.credit_rank(a, c), ref.credit_rank_ref(a, c)))
    cnd32 = cnd.to(torch.int32)
    record("credit_rank", cases, lambda: K.credit_rank(act, cnd),
           lambda: ref.credit_rank_ref(act, cnd),
           lambda: torch.cumsum(cnd32, dim=-1),
           nbytes=2 * R * L + 4 * R * L, nops=8 * R * L, ops_per_call=1)

    # -- arb_winner: [P, L] ready plane, [L] pointer ------------------------
    rdy = rand_bool((P, L), 0.05)
    rdy[:, :64] = False                    # nobody ready: fill-value ties
    rr = torch.randint(0, P, (L,), generator=g, dtype=torch.int32).to(dev)
    cases = [("P=65 L=4096", K.arb_winner(rdy, rr),
              ref.arb_winner_ref(rdy, rr))]
    for shape in ((3, 17), (P, 1), (P, 4097)):
        r_ = rand_bool(shape, 0.3)
        p_ = torch.randint(0, shape[0], (shape[1],), generator=g,
                           dtype=torch.int32).to(dev)
        cases.append((f"{shape}", K.arb_winner(r_, p_),
                      ref.arb_winner_ref(r_, p_)))
    allready = torch.ones((P, L), dtype=torch.bool, device=dev)
    cases.append(("all ready", K.arb_winner(allready, rr),
                  ref.arb_winner_ref(allready, rr)))
    wide = torch.randint(-40 * P, 40 * P, (L,), generator=g,
                         dtype=torch.int32).to(dev)
    cases.append(("rr negative and >= P", K.arb_winner(rdy, wide),
                  ref.arb_winner_ref(rdy, wide)))
    r4 = rand_bool((4, P, L), 0.05)
    p4 = torch.randint(-P, 2 * P, (4, L), generator=g,
                       dtype=torch.int32).to(dev)
    cases.append(("lead (4,)", K.arb_winner(r4, p4),
                  ref.arb_winner_ref(r4, p4)))
    nobody = torch.zeros((P, L), dtype=torch.bool, device=dev)
    cases.append(("none ready", K.arb_winner(nobody, wide),
                  ref.arb_winner_ref(nobody, wide)))
    prio = (torch.arange(P, device=dev, dtype=torch.int32)[:, None]
            - rr[None, :]) % P
    score = torch.where(rdy, prio, torch.full_like(prio, P))
    record("arb_winner", cases, lambda: K.arb_winner(rdy, rr),
           lambda: ref.arb_winner_ref(rdy, rr),
           lambda: torch.argmin(score, dim=0),
           nbytes=P * L + 4 * L + 4 * L, nops=6 * P * L)

    # -- count_fold: [R, L] and [L] delivery planes, int8 codes ------------
    def codes(shape):
        """int8 codes of every kind: 0..15 mostly, negative and past 15
        (the HOME_TXN sentinel 100 at every 7th lane)."""
        c = torch.randint(-128, 128, shape, generator=g, dtype=torch.int8)
        c = torch.where(torch.rand(shape, generator=g) < 0.6,
                        torch.randint(0, 16, shape, generator=g,
                                      dtype=torch.int8), c)
        c.view(-1)[::7] = 100
        return c.to(dev)

    def base():
        return (torch.randint(0, 2 ** 20, (16,), generator=g,
                              dtype=torch.int32).to(dev),
                torch.randint(0, 2 ** 20, (), generator=g,
                              dtype=torch.int32).to(dev))

    msk = rand_bool((R, L), 0.05)
    msg = torch.randint(0, 16, (R, L), generator=g,
                        dtype=torch.int8).to(dev)
    pay = rand_bool((R, L), 0.5)
    cases = [("R=64 L=4096", K.count_fold(msk, msg, pay),
              ref.count_fold_ref(msk, msg, pay))]
    for shape, pm in (((L,), 0.5), ((7, 5), 1.0), ((R, L), 0.0),
                      ((L + 1,), 0.5), ((2048,), 0.5), ((2049,), 0.5),
                      ((8193,), 0.5), ((2048, L), 0.05)):
        m_, p_ = rand_bool(shape, pm), rand_bool(shape, 0.5)
        g_ = codes(shape)
        b_ = base()
        cases.append((f"{shape}", K.count_fold(m_, g_, p_),
                      ref.count_fold_ref(m_, g_, p_)))
        cases.append((f"{shape} base", K.count_fold(m_, g_, p_, base=b_),
                      ref.count_fold_ref(m_, g_, p_, base=b_)))
    home = torch.full((L,), 100, dtype=torch.int8, device=dev)
    ones = torch.ones(L, dtype=torch.bool, device=dev)
    cases.append(("HOME_TXN codes", K.count_fold(ones, home, ones),
                  ref.count_fold_ref(ones, home, ones)))
    # the engine's two shapes with base, codes of every kind
    mixed = codes((R, L))
    row = codes((L,))
    b_ = base()
    cases.append(("R=64 L=4096 base, codes of every kind",
                  K.count_fold(msk, mixed, pay, base=b_),
                  ref.count_fold_ref(msk, mixed, pay, base=b_)))
    cases.append(("L=4096 base, codes of every kind",
                  K.count_fold(ones, row, pay[0], base=b_),
                  ref.count_fold_ref(ones, row, pay[0], base=b_)))
    # storage offsets: one shared phase (a scalar head), and none shared
    for offs in ((5, 5, 5), (0, 3, 1)):
        vs = [view_at(t, o) for t, o in zip((msk, mixed, pay), offs)]
        cases.append((f"storage offsets {offs} B",
                      K.count_fold(*vs, base=b_),
                      ref.count_fold_ref(*vs, base=b_)))
    # 1,000 launches back to back, each folding into the last one's
    # totals, alternating the [R, L] and [L] planes: a ticket that does
    # not reset shows in the totals
    planes = ((msk, mixed, pay), (ones, row, pay[0]))
    steps = [torch.cat([d[0], d[1][None]])
             for d in (ref.count_fold_ref(*pl) for pl in planes)]
    tot = (torch.zeros(16, dtype=torch.int32, device=dev),
           torch.zeros((), dtype=torch.int32, device=dev))
    outs = []
    for i in range(1000):
        tot = K.count_fold(*planes[i % 2], base=tot)
        outs.append(torch.cat([tot[0], tot[1][None]]))
    cases.append(("1,000 launches back to back", torch.stack(outs),
                  torch.cumsum(torch.stack([steps[i % 2]
                                            for i in range(1000)]),
                               dim=0, dtype=torch.int32)))
    # the grouped form (a fleet's members): G groups in one launch, each
    # on its own base row; G = 1 is the ungrouped call's launch
    for G, n in ((1, R * L), (3, L + 1), (12, 2049), (4, R * L)):
        m_, p_ = rand_bool((G, n), 0.05), rand_bool((G, n), 0.5)
        g_ = codes((G, n))
        bg = (torch.randint(0, 2 ** 20, (G, 16), generator=g,
                            dtype=torch.int32).to(dev),
              torch.randint(0, 2 ** 20, (G,), generator=g,
                            dtype=torch.int32).to(dev))
        cases.append((f"grouped G={G} n={n}",
                      K.count_fold(m_, g_, p_, grouped=True),
                      ref.count_fold_ref(m_, g_, p_, grouped=True)))
        cases.append((f"grouped G={G} n={n} base",
                      K.count_fold(m_, g_, p_, base=bg, grouped=True),
                      ref.count_fold_ref(m_, g_, p_, base=bg,
                                         grouped=True)))
    one = K.count_fold(msk[None], mixed[None], pay[None],
                       base=(b_[0][None], b_[1][None]), grouped=True)
    cases.append(("grouped G=1 == the ungrouped launch",
                  (one[0][0], one[1][0]),
                  K.count_fold(msk, mixed, pay, base=b_)))
    msg64 = msg.reshape(-1).to(torch.int64)
    wts = msk.reshape(-1).to(torch.float32)
    b0 = base()                 # the main path's call folds the totals
    row_ms, row_ops = device_ms(lambda: K.count_fold(ones, row, pay[0],
                                                     base=b0))
    print(f"kernel count_fold at [{L}] (one CTA): device "
          f"{row_ms * 1e3:.3f} us in {row_ops:g} ops")
    record("count_fold", cases, lambda: K.count_fold(msk, msg, pay, base=b0),
           lambda: ref.count_fold_ref(msk, msg, pay, base=b0),
           lambda: torch.bincount(msg64, weights=wts, minlength=16),
           nbytes=3 * R * L + 2 * 4 * 17, nops=4 * R * L, ops_per_call=1)

    # -- lat_hist: [R, L] latencies, retired lanes --------------------------
    lat = torch.randint(-4, 600, (R, L), generator=g,
                        dtype=torch.int32).to(dev)
    ret = rand_bool((R, L), 0.05)
    edges = K.LAT_EDGES
    cases = [("R=64 L=4096", K.lat_hist(lat, ret),
              ref.lat_hist_ref(lat, ret, edges))]
    neg = torch.full((3, 7), -5, dtype=torch.int32, device=dev)
    all3 = torch.ones((3, 7), dtype=torch.bool, device=dev)
    cases.append(("negative", K.lat_hist(neg, all3),
                  ref.lat_hist_ref(neg, all3, edges)))
    none = torch.zeros((R, L), dtype=torch.bool, device=dev)
    cases.append(("none retired", K.lat_hist(lat, none),
                  ref.lat_hist_ref(lat, none, edges)))
    odd_l = torch.randint(-4, 600, (5, 4099), generator=g,
                          dtype=torch.int32).to(dev)
    odd_r = rand_bool((5, 4099), 0.5)
    cases.append(("(5, 4099)", K.lat_hist(odd_l, odd_r),
                  ref.lat_hist_ref(odd_l, odd_r, edges)))
    # contiguous views with a storage offset: starts 1 byte (retired) and
    # 8 bytes (lat) past a 16-byte edge share no alignment (every lane one
    # at a time); 12 and 16 bytes share one 4 lanes in (a scalar head,
    # then 16 lanes at a time)
    for r_off, l_off in ((1, 2), (12, 4)):
        ret_v = torch.zeros(R * L + r_off, dtype=torch.bool,
                            device=dev)[r_off:].view(R, L)
        lat_v = torch.zeros(R * L + l_off, dtype=torch.int32,
                            device=dev)[l_off:].view(R, L)
        ret_v.copy_(ret)
        lat_v.copy_(lat)
        cases.append((f"storage offsets {r_off} B, {4 * l_off} B",
                      K.lat_hist(lat_v, ret_v),
                      ref.lat_hist_ref(lat_v, ret_v, edges)))
    one_bin = torch.full((R, L), 3, dtype=torch.int32, device=dev)
    every = torch.ones((R, L), dtype=torch.bool, device=dev)
    cases.append(("every lane retired into one bin",
                  K.lat_hist(one_bin, every),
                  ref.lat_hist_ref(one_bin, every, edges)))
    edges_t = torch.as_tensor(edges, dtype=torch.int32, device=dev)
    record("lat_hist", cases, lambda: K.lat_hist(lat, ret),
           lambda: ref.lat_hist_ref(lat, ret, edges),
           lambda: torch.bucketize(lat, edges_t, right=True),
           nbytes=5 * R * L + 4 * R * 10, nops=20 * R * L)

    # -- packed_any / packed_fanout: the packed two-home path's word
    #    planes, [H, L/H, W] int32 words with [H, L/H] per-line inputs,
    #    and the [H, 2, L/H, W] view and pending arrays whose planes the
    #    step reads where they lie --------------------------------------
    from repro_torch.core import directory_mn as dmn
    Lh = L // HOMES
    n_lines = HOMES * Lh

    def words(p, lead=(HOMES,), r=R, lines=Lh):
        return dmn.pack_mask(rand_bool(lead + (r, lines), p))

    pres = words(0.3)
    excl = pres & words(0.5)
    if tuple(pres.shape) != (HOMES, Lh, NW):
        fail(f"packed words of shape {tuple(pres.shape)}")
    sparse = pres & words(0.01)
    view = torch.stack([pres, excl], dim=-3)          # [H, 2, L/H, W]
    pend = torch.stack([words(0.002), words(0.002)], dim=-3)
    need_s, need_i = words(0.002), words(0.002)
    grant = (need_s, need_i, pend[:, 0], pend[:, 1])  # phase 6's planes
    if any(p.is_contiguous() for p in (view[:, 0], pend[:, 1])):
        fail("the packed view's planes should be strided slices")
    edge_words = {
        "W=1 (R=8)": words(0.1, (), 8, L),
        "ragged W=2 (R=33)": words(0.05, (), 33, L),
        "bit 31": torch.full((Lh, NW), -2 ** 31, dtype=torch.int32,
                             device=dev),
        "all zero": torch.zeros((HOMES, Lh, NW), dtype=torch.int32,
                                device=dev),
        "all ones": torch.full((HOMES, Lh, NW), -1, dtype=torch.int32,
                               device=dev),
    }
    cases = [("[2, 2048, 2]", K.packed_any(sparse),
              ref.packed_any_ref(sparse))]
    for what, w_ in edge_words.items():
        cases.append((what, K.packed_any(w_), ref.packed_any_ref(w_)))
    several = {
        "view slices, 2 planes": (view[:, 0], view[:, 1]),
        "fan-out planes and pending slices, 4 planes": grant,
        "pending slices, 2 planes": (pend[:, 0], pend[:, 1]),
        "W=1 (R=8), 3 planes": tuple(words(0.01, (), 8, L)
                                     for _ in range(3)),
        "ragged W=2 (R=33), 4 planes": tuple(words(0.005, (), 33, L)
                                             for _ in range(4)),
        "bit 31, 2 planes": (edge_words["bit 31"],
                             edge_words["bit 31"] & 0),
        "one word off 8 bytes, 4 planes": tuple(view_at(p.contiguous(), 1)
                                                for p in grant),
    }
    for what, planes in several.items():
        cases.append((what, K.packed_any(*planes),
                      ref.packed_any_ref(*planes)))
    # the row times one plane, the form of three of a packed step's four
    # launches (absorb's no-sharers test twice, the pending test)
    record("packed_any", cases, lambda: K.packed_any(sparse),
           lambda: ref.packed_any_ref(sparse),
           lambda: torch.any(sparse, dim=-1),
           nbytes=4 * n_lines * NW + n_lines, nops=2 * n_lines * NW,
           ops_per_call=1)
    time_form("packed_any, 4 planes (phase 6: the fan-out planes and the "
              "pending slices)", "packed_any", lambda: K.packed_any(*grant),
              lambda: ref.packed_any_ref(*grant),
              nbytes=4 * 4 * n_lines * NW + n_lines,
              nops=8 * n_lines * NW)

    node = torch.randint(0, R, (HOMES, Lh), generator=g,
                         dtype=torch.int32).to(dev)
    node[:, :4] = torch.tensor([0, 31, 32, 63], dtype=torch.int32,
                               device=dev)
    sh = rand_bool((HOMES, Lh), 0.3)
    ex = rand_bool((HOMES, Lh), 0.3) & ~sh
    home = rand_bool((HOMES, Lh), 0.1)
    hr = home & rand_bool((HOMES, Lh), 0.6)
    hw = home & rand_bool((HOMES, Lh), 0.6)
    step_args = (view[:, 0], view[:, 1], node, sh, ex, hr, hw)
    cases = [("[2, 2048, 2]", K.packed_fanout(pres, excl, node, sh, ex),
              ref.packed_fanout_ref(pres, excl, node, sh, ex)),
             ("view slices", K.packed_fanout(*step_args[:5]),
              ref.packed_fanout_ref(*step_args[:5])),
             ("view slices, home flags", K.packed_fanout(*step_args),
              ref.packed_fanout_ref(*step_args))]
    for what, w_ in edge_words.items():
        wl = w_.shape[-2]
        lead = tuple(w_.shape[:-2])
        n_ = torch.randint(0, 32 * w_.shape[-1], lead + (wl,), generator=g,
                           dtype=torch.int32).to(dev)
        s_ = rand_bool(lead + (wl,), 0.5)
        x_ = ~s_
        h_ = rand_bool(lead + (wl,), 0.3)
        r_, w2 = h_ & rand_bool(lead + (wl,), 0.6), \
            h_ & rand_bool(lead + (wl,), 0.6)
        e_ = w_ & torch.roll(w_, 1, dims=-2)
        for flags in ((), (r_, w2)):
            cases.append((what + (", home flags" if flags else ""),
                          K.packed_fanout(w_, e_, n_, s_, x_, *flags),
                          ref.packed_fanout_ref(w_, e_, n_, s_, x_,
                                                *flags)))
    ones = torch.ones((HOMES, Lh), dtype=torch.bool, device=dev)
    for what, flags in (("all lines requesting", ()),
                        ("all lines requesting, home flags", (hr, hw)),
                        ("every line the home's", (ones, ones))):
        args = (view[:, 0], view[:, 1], node, ones, ones) + flags
        cases.append((what, K.packed_fanout(*args),
                      ref.packed_fanout_ref(*args)))
    hot = ref.node_hot(node, NW)
    # the row times the step's form: the view's planes where they lie,
    # the home flags
    record("packed_fanout", cases,
           lambda: K.packed_fanout(*step_args),
           lambda: ref.packed_fanout_ref(*step_args),
           lambda: torch.where(sh[..., None], excl & ~hot, 0),
           nbytes=16 * n_lines * NW + 8 * n_lines,
           nops=10 * n_lines * NW, ops_per_call=1)
    time_form("packed_fanout, contiguous planes, no home flags (the "
              "reference's form)", "packed_fanout",
              lambda: K.packed_fanout(pres, excl, node, sh, ex),
              lambda: ref.packed_fanout_ref(pres, excl, node, sh, ex),
              nbytes=16 * n_lines * NW + 6 * n_lines,
              nops=8 * n_lines * NW)

    # -- a launch's floor: the empty kernel through the same ctypes route,
    #    on the two kernels' grids -------------------------------------
    for what, threads in (("packed_any", n_lines),
                          ("packed_fanout", n_lines * NW)):
        blocks = (threads + 255) // 256
        floor_ms, _ = ops_ms(f"empty kernel on {what}'s grid",
                             lambda: K.empty_launch(blocks), 100, 1,
                             "empty_kernel")
        print(f"launch floor: an empty kernel of {blocks} CTAs of 256 "
              f"({what}'s grid) through ctypes: device "
              f"{floor_ms * 1e3:.3f} us per launch")
    return rows


def time_form(label: str, own: str, kernel, plain, nbytes, nops,
              iters: int = 100) -> float:
    """Print the device time of one more form of a kernel (one device
    operation a call, its entry named ``own``: ``ops_ms``) beside its
    plain version's and its bound; return the kernel's ms."""
    ms, _ = ops_ms(label, kernel, iters, 1, own)
    plain_ms, plain_ops = device_ms(plain, iters)
    bound = max(nbytes / HBM_BYTES_PER_S, nops / CUDA_CORE_OPS_PER_S)
    print(f"kernel {label}: device {ms * 1e3:.3f} us in 1 op (plain "
          f"{plain_ms * 1e3:.3f} us in {plain_ops:g}, bound "
          f"{bound * 1e6:.3f} us)")
    return ms


def drive_nmp(name: str, call, reps: int, path):
    """``reps`` calls of a pushdown entry point, with every near-memory
    launch count set to 0 just before and read just after: the call's
    kernel must have launched once per call (one shard), the others not at
    all.  Returns the last result and the best wall time in s."""
    import torch
    from repro_torch.kernels import nmp as NK
    torch.cuda.synchronize()
    NK.reset_launches()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = call()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    counts = dict(NK.launches)
    want = {k: reps if k == name else 0 for k in counts}
    if counts != want:
        fail(f"nmp {name}: launches {counts}, expected {want}")
    path[name] += counts[name]
    return out, best


def nmp_select(dev, rows, path):
    """SELECT pushdown (paper Fig. 5) over ``NMP_ROWS`` 128-byte rows."""
    import torch
    from repro_torch.core import pushdown as PD
    from repro_torch.kernels import nmp as NK
    from repro_torch.kernels import ref
    from repro_torch.nmp.select import select_scan
    n, w = NMP_ROWS, SEL_W
    g = torch.Generator(device=dev).manual_seed(51)
    table = torch.randn((n, w), generator=g, device=dev)
    u = torch.rand(n, generator=g, device=dev)
    print(f"nmp SELECT: {n} rows x {w} fp32 ({4 * w}-byte rows, "
          f"{n * w * 4 / 2 ** 30:g} GiB), a > 0 AND b < 1, pushdown_select "
          f"over [{dev}], capacity {n}, best of {NMP_REPS}")
    for sel in SELECTIVITIES:
        match = u < sel
        table[:, 0] = torch.where(match, 1.0, -1.0)
        table[:, 1] = torch.where(match, 0.0, 2.0)
        res, t = drive_nmp("select_scan", lambda: PD.pushdown_select(
            [dev], n, table, 0.0, 1.0), NMP_REPS, path)
        want, count, _ = select_scan(table, 0.0, 1.0, n)
        m = int(match.sum())
        if not (int(res.counts[0]) == int(count) == int(res.moved_rows)
                == m and torch.equal(bits(res.rows[0]), bits(want))):
            fail(f"nmp SELECT sel={sel}: pushdown differs from the "
                 f"predicate's oracle")
        print(f"nmp SELECT sel={sel}: {m} matches, oracle-exact; "
              f"{t * 1e3:.3f} ms per pushdown_select, {n / t:.4e} rows/s; "
              f"moved {PD.pushdown_bytes(res, w, 4)} of "
              f"{PD.bulk_transfer_bytes(table)} bytes")
        del res, want
        if sel != BOUND_SEL:
            continue
        where_the_time_goes("nmp SELECT sel=0.1 pushdown_select", lambda: PD.
                            pushdown_select([dev], n, table, 0.0, 1.0), t)
        nb = n // 256
        nbytes = 32 * n + (4 * w - 32) * m + 4 * n * w + 4 * nb
        print(f"kernel select_scan bound at sel={sel}: {m} of {n} rows "
              f"match; {nbytes} bytes (the 32-byte sector of columns 0-1 "
              f"of every row, the other {4 * w - 32} bytes of each "
              f"matching row, the {4 * n * w}-byte output, the counts)")
        cases = [(f"{n} rows, sel 0.1", NK.select_scan(table, 0.0, 1.0),
                  ref.select_scan_ref(table, 0.0, 1.0, 256))]
        gc = torch.Generator(device=dev).manual_seed(53)
        for what, rows_, width, br, x in (
                ("ragged 1000 rows padded, x=-inf", 1000, w, 256, "-inf"),
                ("all-match and zero-match blocks", 1024, w, 256, 0.0),
                ("w=6 (no 16-byte copy), block 64", 640, 6, 64, 0.0),
                ("block 1024", 4096, w, 1024, 0.0),
                ("block 32, -0.0 and NaN payloads", 512, w, 32, 0.0)):
            t_ = torch.randn((rows_, width), generator=gc, device=dev)
            t_[:, 0] = torch.where(torch.rand(rows_, generator=gc,
                                              device=dev) < 0.3, 1.0, -1.0)
            t_[:, 1] = torch.where(t_[:, 0] > 0, 0.0, 2.0)
            if what.startswith("all"):
                t_[:256, :2] = torch.tensor([1.0, 0.0], device=dev)
                t_[256:512, :2] = torch.tensor([-1.0, 2.0], device=dev)
            if "NaN" in what:
                t_[::3, 3] = -0.0
                t_[::5, 4] = float("nan")
            if what.startswith("ragged"):
                fill = torch.full((24, width), torch.finfo(t_.dtype).min,
                                  device=dev)
                t_ = torch.cat([t_, fill])
            xv = float(x)
            cases.append((what, NK.select_scan(t_, xv, 1.0, br),
                          ref.select_scan_ref(t_, xv, 1.0, br)))
        record_kernel(rows, "select_scan", cases,
                      lambda: NK.select_scan(table, 0.0, 1.0),
                      lambda: ref.select_scan_ref(table, 0.0, 1.0, 256),
                      None, nbytes, 0, iters=NMP_ITERS, ops_per_call=1)
        del cases


def regex_oracle(field):
    """Python ``re`` over the ``[n, width]`` uint8 string field, one row per
    line: (match [n] bool, index [n] of the last byte of each row's first
    match, -1 where none)."""
    import re

    import numpy as np
    n, width = field.shape
    blob = np.concatenate([field, np.full((n, 1), 10, np.uint8)],
                          axis=1).tobytes()
    pat = re.compile(PATTERN.encode())
    starts = np.fromiter((m.start() for m in pat.finditer(blob)), np.int64)
    row, col = np.divmod(starts, width + 1)
    first_row, first = np.unique(row, return_index=True)
    match = np.zeros(n, bool)
    match[first_row] = True
    last = np.full(n, -1, np.int64)
    last[first_row] = col[first] + len(PATTERN) - 1
    return match, last


def read_sectors(last, width: int, stride=None, offset: int = 0) -> int:
    """32-byte sectors of an ``[n, width]`` byte field whose row r starts
    at byte ``offset + r * stride`` (``stride`` None: ``width``, a
    contiguous array) that hold bytes 0..last[r] of each row r (the whole
    row where ``last`` is -1), each sector counted once."""
    import numpy as np
    n = last.shape[0]
    start = offset + np.arange(n, dtype=np.int64) * (stride or width)
    end = start + np.where(last < 0, width - 1, last)
    lo, hi = start // 32, end // 32
    prev = np.concatenate([[-1], hi[:-1]])
    return int(np.maximum(0, hi - np.maximum(lo, prev + 1) + 1).sum())


def regex_table(dev, sel: float):
    """The regex phase's table: ``NMP_ROWS`` rows of ``REGEX_W`` random
    lowercase bytes, ``PATTERN`` written into the string field of the rows
    ``u < sel`` at a random position; and ``u``."""
    import torch
    n, width = NMP_ROWS, STR_HI - STR_LO
    g = torch.Generator(device=dev).manual_seed(52)
    table = torch.randint(ord("a"), ord("z") + 1, (n, REGEX_W), generator=g,
                          device=dev, dtype=torch.uint8)
    u = torch.rand(n, generator=g, device=dev)
    pos = torch.randint(0, width - len(PATTERN) + 1, (n,), generator=g,
                        device=dev)
    seed_pattern(table, u, pos, 0.0, sel)
    return table, u, pos


def seed_pattern(table, u, pos, lo: float, hi: float) -> None:
    """Write ``PATTERN`` into the field of the rows with lo <= u < hi."""
    new = ((u < hi) & (u >= lo)).nonzero().squeeze(1)
    for j, c in enumerate(PATTERN.encode()):
        table[new, STR_LO + pos[new] + j] = c


def time_call(label: str, fn, nbytes, ops_per_call: int, own: str,
              iters: int = NMP_ITERS):
    """Print ``fn``'s device time per call (``ops_ms``: ``ops_per_call``
    device operations, one of them named ``own``) beside ``nbytes`` at
    the HBM rate (None: no bound).  Returns the device time in ms."""
    ms, n_ops = ops_ms(label, fn, iters, ops_per_call, own)
    bound = "" if nbytes is None else (
        f", bound {nbytes / HBM_BYTES_PER_S * 1e6:.3f} us ({nbytes} bytes), "
        f"{100 * nbytes / HBM_BYTES_PER_S * 1e3 / ms:.1f}% of it")
    print(f"{label}: device {ms * 1e3:.3f} us in {n_ops:g} ops{bound}; "
          f"{wall_ms(fn, iters) * 1e3:.2f} us per call back to back")
    return ms


def nmp_regex(dev, rows, path):
    """REGEXP_LIKE pushdown (paper Fig. 7) over ``NMP_ROWS`` 128-byte
    rows."""
    import torch
    from repro_torch.core import pushdown as PD
    from repro_torch.kernels import nmp as NK
    from repro_torch.kernels import ref
    from repro_torch.nmp.dfa import dfa_tables, field_bytes
    from repro_torch.nmp.regex import compile_regex
    n, width = NMP_ROWS, STR_HI - STR_LO
    dfa = compile_regex(PATTERN)
    trans, accept = dfa_tables(dfa, dev)
    table, u, pos = regex_table(dev, 0.0)
    print(f"nmp regex: '{PATTERN}' ({dfa.n_states} DFA states) over {n} "
          f"rows of {REGEX_W} random lowercase bytes, string field "
          f"[{STR_LO}, {STR_HI}) read in place, pushdown_regex over "
          f"[{dev}], capacity {n}, best of {NMP_REPS}")
    seeded_below = 0.0
    for sel in SELECTIVITIES:
        seed_pattern(table, u, pos, seeded_below, sel)
        seeded_below = sel
        res, t = drive_nmp("regex_dfa", lambda: PD.pushdown_regex(
            [dev], n, dfa, table, STR_LO, STR_HI), NMP_REPS, path)
        t0 = time.perf_counter()
        match, last = regex_oracle(table[:, STR_LO:STR_HI].cpu().numpy())
        t_oracle = time.perf_counter() - t0
        m = int(match.sum())
        seeded = int((u < sel).sum())
        mt = torch.as_tensor(match).to(dev)
        c = int(res.counts[0])
        if not (c == m == int(res.moved_rows)
                and torch.equal(res.rows[0][:c], table[mt])
                and not bool(res.rows[0][c:].any())):
            fail(f"nmp regex sel={sel}: pushdown differs from python re")
        print(f"nmp regex sel={sel}: {m} matches ({seeded} seeded, "
              f"{m - seeded} by chance), equal to python re "
              f"({t_oracle:.1f} s); {t * 1e3:.3f} ms per pushdown_regex, "
              f"{n / t:.4e} rows/s")
        del res, mt
        if sel != BOUND_SEL:
            continue
        # every device entry of the call: no copy of the string field.
        where_the_time_goes("nmp regex sel=0.1 pushdown_regex", lambda: PD.
                            pushdown_regex([dev], n, dfa, table, STR_LO,
                                           STR_HI), t, top=None)
        tbl_bytes = trans.numel() * 4 + accept.numel()
        sectors = read_sectors(last, width)
        nbytes = 32 * sectors + n + tbl_bytes
        in_place = read_sectors(last, width, REGEX_W, STR_LO)
        nbytes_in_place = 32 * in_place + n + tbl_bytes
        print(f"kernel regex_dfa bound at sel={sel}: {sectors} 32-byte "
              f"sectors of a contiguous {n}x{width} copy of the string "
              f"field up to each row's first accept byte, {tbl_bytes} "
              f"bytes of tables, {n} written: {nbytes} bytes; in place "
              f"(rows {REGEX_W} bytes apart, the field at byte {STR_LO}): "
              f"{in_place} sectors, {nbytes_in_place} bytes")
        field = table[:, STR_LO:STR_HI]
        strings = field.contiguous()
        cases = [(f"{NMP_ROWS} rows, sel 0.1, in place",
                  NK.regex_dfa(trans, accept, field),
                  ref.regex_dfa_ref(trans, accept, field)),
                 (f"{NMP_ROWS} rows, sel 0.1, contiguous copy",
                  NK.regex_dfa(trans, accept, strings),
                  ref.regex_dfa_ref(trans, accept, strings))]
        gc = torch.Generator(device=dev).manual_seed(54)
        big = compile_regex("(a|b)*a(a|b)(a|b)(a|b)(a|b)(a|b)(a|b)")
        if big.n_states <= 64:
            fail(f"the large DFA has only {big.n_states} states")
        ab = torch.randint(ord("a"), ord("c") + 1, (5000, 64), generator=gc,
                           device=dev, dtype=torch.uint8)
        ab40 = ab[:, 8:48].contiguous()
        rnd_t = torch.randint(0, 20, (20, 256), generator=gc, device=dev,
                              dtype=torch.int32)
        rnd_a = torch.rand(20, generator=gc, device=dev) < 0.5
        raw = torch.randint(0, 256, (3000, 17), generator=gc, device=dev,
                            dtype=torch.uint8)
        nul = strings[:1000].clone()
        nul[::2, 20:] = 0
        wide = table[:3000, :1].expand(3000, 256).contiguous()
        wide[:, 50:150] = table[:3000, :100]
        wide200 = wide[:, 40:240].contiguous()
        skew = torch.empty(1000 * width + 1, dtype=torch.uint8,
                           device=dev)[1:].view(1000, width)
        skew.copy_(strings[:1000])        # one byte into its storage
        odd = torch.empty(3000 * REGEX_W + 1, dtype=torch.uint8,
                          device=dev)[1:].view(3000, REGEX_W)
        odd.copy_(table[:3000])           # rows at an odd storage offset
        s130 = torch.randint(ord("a"), ord("z") + 1, (3000, 130),
                             generator=gc, device=dev, dtype=torch.uint8)
        s130[::3, 20:25] = torch.tensor(list(PATTERN.encode()),
                                        dtype=torch.uint8, device=dev)
        flt = table[:3000].float()
        flt[::2, STR_LO + 1] = 376.0      # saturates to 255 (wrapping: 'x')
        flt[1::4, STR_LO + 3] = float("nan")
        for what, (tr, ac), s_ in (
                (f"{big.n_states}-state DFA (table read through L1)",
                 dfa_tables(big, dev), ab40),
                (f"{big.n_states}-state DFA, a view at stride 64",
                 dfa_tables(big, dev), ab[:, 8:48]),
                ("random 20-state table, no state absorbs", (rnd_t, rnd_a),
                 raw),
                ("ragged 1000 rows with NUL tails", (trans, accept), nul),
                ("rows of 200 bytes (read through L1)", (trans, accept),
                 wide200),
                ("rows of 200 bytes, a view at stride 256", (trans, accept),
                 wide[:, 40:240]),
                ("rows not 16-byte aligned", (trans, accept), skew),
                ("in place at an odd storage offset (the field at byte 9)",
                 (trans, accept), odd[:, STR_LO:STR_HI]),
                ("in place at row stride 130 (not a multiple of 16), "
                 "offset 5", (trans, accept), s130[:, 5:67]),
                ("float table cast by field_bytes", (trans, accept),
                 field_bytes(flt[:, STR_LO:STR_HI])),
                ("one row of one byte", (trans, accept), field[:1, :1]),
                ("ragged 777 rows in place", (trans, accept),
                 field[1000:1777])):
            cases.append((what, NK.regex_dfa(tr, ac, s_),
                          ref.regex_dfa_ref(tr, ac, s_)))
        record_kernel(rows, "regex_dfa", cases,
                      lambda: NK.regex_dfa(trans, accept, strings),
                      lambda: ref.regex_dfa_ref(trans, accept, strings),
                      None, nbytes, 0, iters=NMP_ITERS, ops_per_call=1)
        time_call("kernel regex_dfa in place (the path's input)",
                  lambda: NK.regex_dfa(trans, accept, field),
                  nbytes_in_place, 1, "regex_dfa")
        del cases, strings


def probe_bound_bytes(heads, keys, nxt, q, max_chain: int) -> int:
    """Bytes a probe must move at least: the queries read, ``found`` and
    ``steps`` written, and each 32-byte sector of ``heads``, ``keys`` and
    ``nxt`` that the walk reads (keys of the entries it visits, next
    pointers of those it leaves), counted once however often it is read."""
    import torch
    from repro_torch.nmp.kvstore import fib_hash

    def sectors(hit):
        pad = (-hit.numel()) % 8          # 8 int32 per 32-byte sector
        hit = torch.cat([hit, hit.new_zeros(pad)])
        return int(hit.view(-1, 8).any(1).sum())

    bucket = fib_hash(q, heads.shape[0]).to(torch.int64)
    seen_h = torch.zeros(heads.shape[0], dtype=torch.bool, device=q.device)
    seen_h[bucket] = True
    seen_k = torch.zeros(keys.shape[0], dtype=torch.bool, device=q.device)
    seen_n = torch.zeros_like(seen_k)
    ptr = heads[bucket]
    found = torch.full_like(ptr, -1)
    for _ in range(max_chain):
        live = (ptr >= 0) & (found < 0)
        safe = ptr.clamp(min=0).to(torch.int64)
        seen_k[safe[live]] = True
        hit = live & (keys[safe] == q)
        seen_n[safe[live & ~hit]] = True
        found = torch.where(hit, ptr, found)
        ptr = torch.where(live & ~hit, nxt[safe], ptr)
    return (32 * (sectors(seen_h) + sectors(seen_k) + sectors(seen_n))
            + 12 * q.numel())


def kvs_case(dev, g, chain: int):
    """The KVS phase's table at ``chain`` entries a bucket, drawn from
    ``g`` in the phase's order: (keys 1..n, values, the one-shard KVS,
    max_chain, 1 Mi queries, build seconds)."""
    import torch
    from repro_torch.core import pushdown as PD
    from repro_torch.nmp.kvstore import fib_hash
    n = KVS_BUCKETS * chain
    keys = torch.arange(1, n + 1, device=dev)
    vals = torch.randn((n, V_WIDTH), generator=g, device=dev)
    t0 = time.perf_counter()
    kvs = PD.build_sharded_kvs(keys, vals, KVS_BUCKETS, 1, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    longest = int(torch.bincount(fib_hash(keys, KVS_BUCKETS).long(),
                                 minlength=KVS_BUCKETS).max())
    q = torch.randint(1, int(n * (1 + MISS)), (KVS_QUERIES,), generator=g,
                      device=dev).to(torch.int32)
    return keys, vals, kvs, longest + 4, q, t_build


def nmp_kvs(dev, rows, path):
    """KVS pointer chase (paper Fig. 6): 65,536 buckets, chains of 1 to 128
    entries, 1 Mi uniform queries."""
    import torch
    from repro_torch.core import pushdown as PD
    from repro_torch.kernels import nmp as NK
    from repro_torch.kernels import ref
    from repro_torch.nmp.kvstore import KVStore, build_kvs, kvs_lookup, \
        records
    g = torch.Generator(device=dev).manual_seed(55)
    print(f"nmp KVS: {KVS_BUCKETS} buckets x chain {CHAINS} entries "
          f"(an 8-byte record of key and next, {4 * V_WIDTH}-byte value), "
          f"{KVS_QUERIES} queries uniform in [1, {1 + MISS:g} n), "
          f"max_chain = longest chain + 4, pushdown_lookup over [{dev}], "
          f"best of {NMP_REPS}")
    for chain in CHAINS:
        keys, vals, kvs, max_chain, q, t_build = kvs_case(dev, g, chain)
        n, longest = keys.shape[0], max_chain - 4
        (v, found, steps), t = drive_nmp("hash_probe", lambda: PD.
                                         pushdown_lookup([dev], kvs, q,
                                                         max_chain),
                                         NMP_REPS, path)
        one = KVStore(kvs.heads[0], kvs.keys[0], kvs.values[0], kvs.nxt[0])
        wv, wf, ws = kvs_lookup(one, q, max_chain)
        hit = q <= n                        # keys are 1..n, each once
        qi = (q.long() - 1).clamp(0, n - 1)
        if not (torch.equal(bits(v), bits(wv)) and torch.equal(found, wf)
                and torch.equal(steps, ws) and torch.equal(found, hit)
                and torch.equal(v[hit], vals[qi[hit]])):
            fail(f"nmp KVS chain={chain}: pushdown differs from the plain "
                 f"lookup")
        print(f"nmp KVS chain={chain}: {n} entries, longest chain "
              f"{longest}, built in {t_build:.3f} s; {int(found.sum())} "
              f"found, {int((~found).sum())} missed, mean steps "
              f"{float(steps.double().mean()):.3f}, oracle-exact; "
              f"{t * 1e3:.3f} ms per pushdown_lookup, "
              f"{KVS_QUERIES / t:.4e} keys/s")
        if chain != BOUND_CHAIN:
            continue
        where_the_time_goes("nmp KVS chain=32 pushdown_lookup", lambda: PD.
                            pushdown_lookup([dev], kvs, q, max_chain), t)
        heads, keys_b, nxt = one.heads, one.keys, one.nxt
        if records(keys_b, nxt) is None:
            fail("build_sharded_kvs did not lay keys and nxt out as records")
        nbytes = probe_bound_bytes(heads, keys_b, nxt, q, max_chain)
        print(f"kernel hash_probe bound at chain={chain}: {nbytes} bytes "
              f"(queries read, found and steps written, each 32-byte "
              f"sector of heads, keys and nxt the walk reads, once)")
        probes = [("chain 32, 1 Mi queries", heads, keys_b, nxt, q,
                   max_chain),
                  ("max_chain 5, below the longest chain", heads, keys_b,
                   nxt, q, 5),
                  ("max_chain 0", heads, keys_b, nxt, q, 0)]
        gc = torch.Generator(device=dev).manual_seed(56)
        dup = (2 ** 32 - torch.randint(1, 500, (3000,), generator=gc,
                                       device=dev))     # near 2^32, repeats
        for what, nbk, mc in (("duplicate keys near 2^32, 7 buckets", 7,
                               600), ("one bucket", 1, 4000)):
            kv = build_kvs(dup, torch.ones((3000, 1), device=dev), nbk,
                           device=dev)
            qq = torch.cat([kv.keys[::3], kv.keys[:77] ^ 0x5555])
            probes.append((what, kv.heads, kv.keys, kv.nxt, qq, mc))
        cases = []
        for what, h, k, nx, qq, mc in probes:     # each in both layouts
            want = ref.hash_probe_ref(h, k, nx, qq, mc)
            cases.append((f"{what}, records", NK.hash_probe(h, k, nx, qq, mc),
                          want))
            cases.append((f"{what}, two arrays", NK.hash_probe(
                h, k.contiguous(), nx.contiguous(), qq, mc), want))
        record_kernel(rows, "hash_probe", cases,
                      lambda: NK.hash_probe(heads, keys_b, nxt, q,
                                            max_chain),
                      lambda: ref.hash_probe_ref(heads, keys_b, nxt, q,
                                                 max_chain),
                      None, nbytes, 0, iters=NMP_ITERS, ops_per_call=1)
        keys_c, nxt_c = keys_b.contiguous(), nxt.contiguous()
        time_call("kernel hash_probe on two contiguous arrays (interleaved "
                  "into records first)", lambda: NK.hash_probe(
                      heads, keys_c, nxt_c, q, max_chain), nbytes, 2,
                  "hash_probe")
        del cases


def nmp_kernels(dev):
    """``regex_dfa`` and ``hash_probe`` alone at the path's inputs
    (``NMP_ROWS`` rows at 10%, in place and as a contiguous copy; chains of 32 as
    records and as two arrays), each held against its plain version and
    timed: the quick way to compare designs of the two kernels, e.g.
    ``python -c "import torch, chip_smoke as c;
    c.nmp_kernels(torch.device('cuda'))"`` after editing a constant of
    ``csrc/nmp.cu`` (an edit rebuilds)."""
    import torch
    from repro_torch.kernels import nmp as NK
    from repro_torch.kernels import ref
    from repro_torch.nmp.dfa import dfa_tables
    from repro_torch.nmp.regex import compile_regex
    trans, accept = dfa_tables(compile_regex(PATTERN), dev)
    table, _, _ = regex_table(dev, BOUND_SEL)
    field = table[:, STR_LO:STR_HI]
    strings = field.contiguous()
    g = torch.Generator(device=dev).manual_seed(55)
    for chain in CHAINS:
        _, _, kvs, max_chain, q, _ = kvs_case(dev, g, chain)
        if chain == BOUND_CHAIN:
            break
    heads, keys, nxt = kvs.heads[0], kvs.keys[0], kvs.nxt[0]
    keys_c, nxt_c = keys.contiguous(), nxt.contiguous()
    want = ref.regex_dfa_ref(trans, accept, strings)
    found = ref.hash_probe_ref(heads, keys, nxt, q, max_chain)
    for label, fn, ops, exp in (
            ("regex_dfa in place", lambda: NK.regex_dfa(trans, accept, field),
             1, (want,)),
            ("regex_dfa contiguous", lambda: NK.regex_dfa(trans, accept,
                                                          strings), 1,
             (want,)),
            ("hash_probe records", lambda: NK.hash_probe(
                heads, keys, nxt, q, max_chain), 1, found),
            ("hash_probe two arrays", lambda: NK.hash_probe(
                heads, keys_c, nxt_c, q, max_chain), 2, found)):
        got = fn()
        got = got if isinstance(got, tuple) else (got,)
        if not all(torch.equal(a, b) for a, b in zip(got, exp)):
            fail(f"{label} differs from its plain version")
        time_call(f"kernel {label}", fn, None, ops, label.split()[0])


def phase_nmp(dev, rows):
    """Phase 4: the near-memory operators' pushdown at the paper's §5
    sizes on one shard (one card), oracle-checked, with each kernel held
    against its plain version and timed."""
    import torch
    t0 = time.perf_counter()
    path = {"select_scan": 0, "regex_dfa": 0, "hash_probe": 0}
    for run in (nmp_select, nmp_regex, nmp_kvs):
        run(dev, rows, path)
        torch.cuda.empty_cache()
    want = {"select_scan": NMP_REPS * len(SELECTIVITIES),
            "regex_dfa": NMP_REPS * len(SELECTIVITIES),
            "hash_probe": NMP_REPS * len(CHAINS)}
    print(f"nmp path: launches {json.dumps(path)}")
    if path != want:
        fail(f"nmp path launches {path}, expected {want}")
    for name, n in path.items():
        rows[name]["launches"] = n
    print(f"nmp phase {time.perf_counter() - t0:.1f} s")


def attention_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """(query, key) pairs the mask keeps for one (batch, head): the work
    an attention kernel must do on this input."""
    import torch
    qi = torch.arange(Sq)[:, None] + (Sk - Sq)
    kj = torch.arange(Sk)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        keep &= kj <= qi
    if window is not None:
        keep &= (qi - kj) < window
    return int(keep.sum())


def model_kernels(dev, rows):
    """``flash_attention`` and ``rglru_scan`` against their plain versions
    on the card: at the slice's shapes (recurrentgemma-9b's local
    attention and recurrence at B=4, S=2048, bf16) and at the cases of
    ``tests/test_kernels.py`` in fp32 and bf16; timed at the path's
    shapes beside ``scaled_dot_product_attention`` with the same mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import models as MK
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(61)

    def normal(shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    bf = torch.bfloat16
    B_, Hq, Hkv, S_, D = PREFILL_B, 16, 1, PREFILL_S, 256
    q, k, v = (normal((B_, h, S_, D), bf) for h in (Hq, Hkv, Hkv))
    win = WINDOW
    cases = [("[4,16,2048,256]/[4,1,2048,256] bf16, window 2048",
              MK.flash_attention(q, k, v, window=win),
              ref.flash_attention_ref(q, k, v, window=win))]
    for (b, hq, hkv, sq, sk, d, causal, w, cap) in ATTN_CASES + \
            TC_EDGE_CASES:
        for dt in (torch.float32, bf):
            qq, kk, vv = (normal((b, h, s, d), dt)
                          for h, s in ((hq, sq), (hkv, sk), (hkv, sk)))
            cases.append((f"{(b, hq, hkv, sq, sk, d)} causal={causal} "
                           f"window={w} softcap={cap} {dt}",
                           MK.flash_attention(qq, kk, vv, causal=causal,
                                              window=w, softcap=cap),
                           ref.flash_attention_ref(qq, kk, vv, causal=causal,
                                                   window=w, softcap=cap)))
    pairs = attention_pairs(S_, S_, True, win)
    nops = 4 * D * B_ * Hq * pairs
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    pos = torch.arange(S_, device=dev)
    mask = (pos[None, :] <= pos[:, None]) & \
        ((pos[:, None] - pos[None, :]) < win)
    print(f"kernel flash_attention bound: {B_ * Hq} heads x {pairs} "
          f"visible (query, key) pairs x {4 * D} flops = {nops} flops at "
          f"{TENSOR_CORE_FLOPS_PER_S:g} flop/s; {nbytes} bytes (q, k, v "
          f"read, out written)")
    record_kernel(rows, "flash_attention", cases,
                  lambda: MK.flash_attention(q, k, v, window=win),
                  lambda: ref.flash_attention_ref(q, k, v, window=win),
                  lambda: F.scaled_dot_product_attention(
                      q, k, v, attn_mask=mask, enable_gqa=True),
                  nbytes, nops, iters=MODEL_ITERS, tol=ATTN_TOL,
                  ops_rate=TENSOR_CORE_FLOPS_PER_S, ops_per_call=1)
    row = rows["flash_attention"]
    print(f"kernel flash_attention (bf16, tensor cores): "
          f"{nops / row['ms'] / 1e9:.1f} TFLOP/s, "
          f"{100 * row['bound_ms'] / row['ms']:.1f}% of its bound; "
          f"{row['library_ms'] / row['ms']:.3f}x faster than "
          f"scaled_dot_product_attention")
    del cases

    x = normal((B_, S_, WIDTH), bf)
    a = torch.sigmoid(normal((B_, S_, WIDTH), torch.float32)).to(bf)
    cases = [("[4,2048,4096] bf16", MK.rglru_scan(x, a),
              ref.rglru_scan_ref(x, a))]
    for (b, s_, d) in RGLRU_CASES + RGLRU_EDGE_CASES:
        for dt in (torch.float32, bf):
            xx = normal((b, s_, d), dt)
            aa = torch.sigmoid(normal((b, s_, d), torch.float32)).to(dt)
            cases.append((f"{(b, s_, d)} {dt}", MK.rglru_scan(xx, aa),
                          ref.rglru_scan_ref(xx, aa)))
    for dt in (torch.float32, bf):
        xx = normal((2, PREFILL_S, 256), dt)
        u = torch.rand((2, PREFILL_S, 256), generator=g, device=dev)
        for what, aa in (("a near 1", 1 - 2e-3 * u), ("a near 0", 1e-2 * u)):
            aa = aa.to(dt)
            cases.append((f"(2, {PREFILL_S}, 256) {what} {dt}",
                          MK.rglru_scan(xx, aa), ref.rglru_scan_ref(xx, aa)))
        # one element past the pair's alignment: channels one at a time
        flat = normal((2 * 300 * 64 + 2,), dt)
        xo, ao = flat[1:-1].view(2, 300, 64), torch.sigmoid(
            flat[2:].float()).to(dt).view(2, 300, 64)
        cases.append((f"storage offset 1 {dt}", MK.rglru_scan(xo, ao),
                      ref.rglru_scan_ref(xo, ao)))
    nbytes = 3 * x.numel() * x.element_size()
    print(f"kernel rglru_scan bound: {nbytes} bytes (x and a read, h "
          f"written); no one PyTorch call computes the scan")
    record_kernel(rows, "rglru_scan", cases, lambda: MK.rglru_scan(x, a),
                  lambda: ref.rglru_scan_ref(x, a), None, nbytes,
                  6 * x.numel(), iters=MODEL_ITERS, tol=RGLRU_TOL,
                  ops_per_call=RGLRU_KERNELS_PER_CALL)
    del cases, q, k, v, x, a
    torch.cuda.empty_cache()


def rehearse_attention(dev):
    """A new attention kernel's first call on the card: build
    ``models.cu`` with ptxas's report, run ``flash_attention`` once at
    recurrentgemma-9b's shapes in bf16 and hold it against its plain
    version, then stop.

        python -c "import torch, chip_smoke as c;
            c.rehearse_attention(torch.device('cuda'))"
    """
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import models as MK
    from repro_torch.kernels import ref
    t0 = time.perf_counter()
    report = []
    build.build("models", verbose=True, log=report.append)
    print(f"build models {time.perf_counter() - t0:.2f} s")
    for line in ptxas_summary("".join(report), "flash_attention_tc_kernel"):
        print(f"ptxas: flash_attention_tc_kernel {line}")
    g = torch.Generator(device=dev).manual_seed(61)
    q, k, v = (torch.randn((PREFILL_B, h, PREFILL_S, 256), generator=g,
                           device=dev).bfloat16() for h in (16, 1, 1))
    got = MK.flash_attention(q, k, v, window=WINDOW)
    want = ref.flash_attention_ref(q, k, v, window=WINDOW)
    err = float((got.float() - want.float()).abs().max())
    ok = torch.allclose(got.float(), want.float(), atol=ATTN_TOL["bfloat16"],
                        rtol=ATTN_TOL["bfloat16"])
    ms = wall_ms(lambda: MK.flash_attention(q, k, v, window=WINDOW),
                 iters=10)
    print(f"flash_attention [4,16,2048,256]/[4,1,2048,256] bf16: max abs "
          f"err {err:g} ({'allclose' if ok else 'NOT allclose'} at "
          f"{ATTN_TOL['bfloat16']}); {ms * 1e3:.3f} us per call")
    if not ok:
        fail("flash_attention differs from its plain version")


def card_params(tree, dev):
    """A copy on ``dev`` of any tree of dicts, lists and tuples of tensors
    (the port's parameters, a decode state, a cross K/V)."""
    if isinstance(tree, dict):
        return {k: card_params(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(card_params(v, dev) for v in tree)
    return tree.to(dev)


def tree_bytes(tree) -> int:
    """The bytes of every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_bytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def attention_launches(cfg) -> dict:
    """The kernel launches of one forward of ``cfg`` on the card: one
    ``flash_attention`` per attention block whose lengths tile (every
    one at smoke size: the decoder's, the encoder's and the cross
    blocks), one ``rglru_scan`` per recurrent block, none for RWKV."""
    from repro_torch.models import transformer as T
    kinds = T.layer_kinds(cfg)
    n = sum(k in ("ga", "la") for k in kinds)
    if cfg.encoder is not None:
        n += cfg.encoder.n_layers + cfg.n_superlayers
    return {"flash_attention": n, "rglru_scan": kinds.count("rg")}


def model_smoke_configs(dev, archs=SMOKE_ARCHS[:6], extra=()):
    """Smoke configs in fp32, the same parameters on the card (kernels)
    and the CPU (plain versions): forward logits at B=2, S=16 and 12
    decode steps allclose at 2e-4 (whisper with 16 frames, its cross K/V
    computed once for the decode), and ``attention_launches`` in each
    forward.  ``extra``: (label, config, tolerance) held the same way."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import models as MK
    from repro_torch.models import transformer as T
    cases = [(arch, get_config(arch, smoke=True), 2e-4) for arch in archs]
    for arch, cfg, tol in cases + list(extra):
        gen = torch.Generator(device="cpu").manual_seed(62)
        cpu_p = T.init_params(cfg, generator=gen, device="cpu")
        card_p = card_params(cpu_p, dev)
        toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
        frames = cross_c = cross_g = None
        if cfg.encoder is not None:
            frames = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                                 generator=gen)
        MK.reset_launches()
        got = T.forward(card_p, cfg, toks.to(dev),
                        frames=None if frames is None else frames.to(dev))
        counts = dict(MK.launches)
        want_counts = attention_launches(cfg)
        if counts != want_counts:
            fail(f"model {arch} smoke: launches {counts}, expected "
                 f"{want_counts}")
        want = T.forward(cpu_p, cfg, toks, frames=frames)
        err_f = float((got.cpu() - want).abs().max())
        if not torch.allclose(got.cpu(), want, atol=tol, rtol=tol):
            fail(f"model {arch} smoke: forward on the card differs from "
                 f"the CPU's, max abs err {err_f}")
        if frames is not None:
            cross_c = T.cross_kv(cpu_p, cfg, T.encode(cpu_p, cfg, frames))
            cross_g = T.cross_kv(card_p, cfg,
                                 T.encode(card_p, cfg, frames.to(dev)))
        st_g = T.init_decode_state(cfg, 2, 12, dev)
        st_c = T.init_decode_state(cfg, 2, 12, "cpu")
        err_d = 0.0
        for t in range(12):
            lg_g, st_g = T.decode_step(card_p, cfg, toks[:, t].to(dev), t,
                                       st_g, cross=cross_g)
            lg_c, st_c = T.decode_step(cpu_p, cfg, toks[:, t], t, st_c,
                                       cross=cross_c)
            err_d = max(err_d, float((lg_g.cpu() - lg_c).abs().max()))
            if not torch.allclose(lg_g.cpu(), lg_c, atol=tol, rtol=tol):
                fail(f"model {arch} smoke: decode step {t} on the card "
                     f"differs from the CPU's, max abs err {err_d}")
        print(f"model {arch} smoke (fp32): card == CPU at {tol:g}, forward "
              f"max abs err {err_f:.3g}, 12 decode steps {err_d:.3g}; "
              f"launches "
              f"{json.dumps(counts)}"
              + (f" ({cfg.encoder.n_layers + cfg.n_superlayers} of them "
                 f"non-causal)" if cfg.encoder is not None else ""))


def model_path(dev, rows, measured=None):
    """The slice at full width and depth: recurrentgemma-9b in bf16,
    parameters drawn on the card.  Prefill ``forward(last_only=True)`` at
    B=4, S=2048 (warm-up, then the best of 3) with its device time split
    by the profiler; then four requests served as ``ServeEngine`` does:
    128-token prompts fed through ``decode_step``, the last logits held
    against ``forward(last_only=True)`` over the same prompts, and 32
    tokens decoded greedily.  Every launch count is set to 0 just before
    the path and read just after.  The best prefill's seconds go to
    ``measured["prefill_s"]`` (phase 14)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import models as MK
    from repro_torch.models import transformer as T
    cfg = get_config(MODEL)
    kinds = T.layer_kinds(cfg)
    per_fwd = {"flash_attention": kinds.count("la"),
               "rglru_scan": kinds.count("rg")}
    if per_fwd != {"flash_attention": 12, "rglru_scan": 26}:
        fail(f"{MODEL}: layer kinds {per_fwd}")
    gen = torch.Generator(device=dev).manual_seed(63)
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    n_par = sum(v.numel() for v in params["embed"].values()) + sum(
        v.numel() for layer in params["layers"] for blk in layer.values()
        for v in blk.values())
    print(f"model path: {MODEL} (published config: {cfg.n_layers} layers, "
          f"d={cfg.d_model}, d_ff={cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}, pattern {cfg.block_pattern}+{cfg.tail_pattern}) "
          f"bf16, {n_par} parameters ({2 * n_par / 1e9:.2f} GB) drawn on "
          f"the card in {time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab, (PREFILL_B, PREFILL_S), generator=gen,
                         device=dev)
    prompts = toks[:, :PROMPT]
    torch.cuda.synchronize()
    MK.reset_launches()
    n_fwd = 0

    def prefill():
        nonlocal n_fwd
        n_fwd += 1
        return T.forward(params, cfg, toks, last_only=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lg = prefill()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        lg = prefill()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    if lg.shape != (PREFILL_B, 1, cfg.padded_vocab) or \
            not bool(lg[..., :cfg.vocab].isfinite().all()):
        fail(f"model path: prefill logits {tuple(lg.shape)} not finite")
    if measured is not None:
        measured["prefill_s"] = best
    ntok = PREFILL_B * PREFILL_S
    print(f"model path prefill: B={PREFILL_B} S={PREFILL_S} "
          f"forward(last_only=True) best of 3 {best * 1e3:.3f} ms "
          f"({ntok / best:.1f} tokens/s; first call {first * 1e3:.1f} ms); "
          f"peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} "
          f"GiB")

    # -- four requests: prompt through decode_step, then greedy decode ----
    max_seq = PROMPT + NEW_TOKENS
    state = T.init_decode_state(cfg, PREFILL_B, max_seq, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(PROMPT):
        dec, state = T.decode_step(params, cfg, prompts[:, t], t, state)
    torch.cuda.synchronize()
    t_prompt = time.perf_counter() - t0
    n_fwd += 1
    pre = T.forward(params, cfg, prompts, last_only=True)[:, 0]
    V = cfg.vocab
    gap = float((dec[:, :V] - pre[:, :V]).abs().max())
    mean_gap = float((dec[:, :V] - pre[:, :V]).abs().mean())
    top2 = pre[:, :V].topk(2).values
    margin = float((top2[:, 0] - top2[:, 1]).min())
    scale = float(pre[:, :V].abs().max())
    top1 = int((dec[:, :V].argmax(-1) == pre[:, :V].argmax(-1)).sum())
    print(f"model path serve: {PREFILL_B} prompts of {PROMPT} tokens fed "
          f"through decode_step in {t_prompt:.3f} s "
          f"({PREFILL_B * PROMPT / t_prompt:.1f} tokens/s); last logits "
          f"against forward(last_only=True): max abs gap {gap:.4f}, mean "
          f"{mean_gap:.4f} (logits up to {scale:.3f}), top-1 agreement "
          f"{top1}/{PREFILL_B} (smallest top-1 margin of the prefill "
          f"{margin:.4f})")
    if not gap <= BF16_GAP_BOUND:
        fail(f"model path: bf16 decode/prefill gap {gap} above "
             f"{BF16_GAP_BOUND}")
    tok = dec[:, :V].argmax(-1)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(NEW_TOKENS):
        out.append(tok)
        lg_d, state = T.decode_step(params, cfg, tok, PROMPT + i, state)
        tok = lg_d[:, :V].argmax(-1)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    gen_toks = torch.stack(out, 1)
    if gen_toks.shape != (PREFILL_B, NEW_TOKENS) or \
            not bool(lg_d[:, :V].isfinite().all()):
        fail("model path: greedy decode produced no finite logits")
    counts = dict(MK.launches)
    want = {k: n * n_fwd for k, n in per_fwd.items()}
    print(f"model path decode: {NEW_TOKENS} greedy tokens x {PREFILL_B} "
          f"requests in {t_dec:.3f} s ({t_dec / NEW_TOKENS * 1e3:.2f} ms "
          f"per step, {PREFILL_B * NEW_TOKENS / t_dec:.1f} tokens/s); "
          f"first request's tokens {gen_toks[0, :8].tolist()}...")
    print(f"model path: launches {json.dumps(counts)} over {n_fwd} "
          f"forwards ({json.dumps(per_fwd)} each; decode launches none)")
    if counts != want:
        fail(f"model path: launches {counts}, expected {want}")
    for name, n in counts.items():
        rows[name]["launches"] = n

    on_card = device_entries(prefill, iters=1)   # one more, profiled
    kernels = {"flash_attention_tc_kernel": "flash (tensor cores)",
               "flash_attention_simt_kernel": "flash (CUDA cores)",
               "rglru_scan_kernel": "rglru_scan"}
    split = dict.fromkeys(list(kernels.values()) + ["rest"], 0.0)
    calls = dict.fromkeys(split, 0)
    for ev in on_card:
        key = next((v for k, v in kernels.items() if k in ev.key), "rest")
        split[key] += ev.self_device_time_total / 1e3
        calls[key] += ev.count
    total = sum(split.values())
    top = sorted((ev for ev in on_card
                  if not any(k in ev.key for k in kernels)),
                 key=lambda ev: -ev.self_device_time_total)[:3]
    print(f"model path prefill device time: {total:.3f} ms of "
          f"{best * 1e3:.3f} ms wall (idle "
          f"{100 * (1 - total / (best * 1e3)):.1f}%); " + ", ".join(
              f"{k} {split[k]:.3f} ms in {calls[k]} entries"
              for k in kernels.values()) +
          f", the rest {split['rest']:.3f} ms (longest: " + "; ".join(
              f"{ev.key[:40]} {ev.self_device_time_total / 1e3:.3f} ms"
              for ev in top) + ")")
    if calls["flash (CUDA cores)"] or \
            calls["flash (tensor cores)"] < per_fwd["flash_attention"]:
        fail(f"model path: the bf16 prefill ran {calls} kernel entries; "
             f"expected {per_fwd['flash_attention']} tensor-core flash "
             f"entries and no CUDA-core one")
    want_scans = per_fwd["rglru_scan"] * RGLRU_KERNELS_PER_CALL
    if calls["rglru_scan"] != want_scans:
        fail(f"model path: the bf16 prefill ran {calls['rglru_scan']} "
             f"rglru_scan entries; expected {want_scans}")
    ragged_prefill(params, cfg, toks, best)
    where_the_time_goes("model path decode_step", lambda: T.decode_step(
        params, cfg, tok, PROMPT + NEW_TOKENS - 1, state), t_dec / NEW_TOKENS)
    del params, state, lg, pre, dec, lg_d
    torch.cuda.empty_cache()


def ragged_prefill(params, cfg, toks, best_tiled: float) -> None:
    """recurrentgemma-9b's prefill over a prompt that does not tile (B=4,
    ``RAGGED_S`` tokens of ``toks``): the RG-LRU scan takes its plain,
    chunked version and attention the dense fall-through, as the
    reference routes them; no kernel launches.  A warm-up call, one
    timed, one profiled for its device operations."""
    import torch
    from repro_torch.kernels import models as MK
    from repro_torch.models import transformer as T
    ragged = toks[:, :RAGGED_S]
    before = dict(MK.launches)

    def prefill():
        return T.forward(params, cfg, ragged, last_only=True)

    prefill()
    lg, wall = _timed(prefill)
    _, p_wall, busy, n_ops, split = profiled(prefill)
    if dict(MK.launches) != before:
        fail(f"model path ragged prefill: launches went from {before} to "
             f"{dict(MK.launches)}; S={RAGGED_S} takes no kernel")
    if lg.shape != (PREFILL_B, 1, cfg.padded_vocab) or \
            not bool(lg[..., :cfg.vocab].isfinite().all()):
        fail(f"model path ragged prefill: logits {tuple(lg.shape)} not "
             f"finite")
    ntok = PREFILL_B * RAGGED_S
    dev_txt = ("device time not measured (the profiler recorded none)"
               if busy is None else
               f"profiled: device {busy:.3f} ms in {n_ops} operations of "
               f"{p_wall:.3f} ms wall (idle {100 * (1 - busy / p_wall):.1f}"
               f"%); longest: " + "; ".join(
                   f"{k[:40]} {ms:.3f} ms" for k, ms in split[:4]))
    print(f"model path ragged prefill: B={PREFILL_B} S={RAGGED_S} (the "
          f"plain chunked RG-LRU scan, dense attention; 0 rglru_scan and "
          f"0 flash_attention launches) {wall * 1e3:.3f} ms "
          f"({ntok / wall:.1f} tokens/s) beside S={PREFILL_S}'s "
          f"{best_tiled * 1e3:.3f} ms through the kernels; {dev_txt}")


def model_exact(dev):
    """fp32 at full width, depth cut to one superlayer and the tail: decode
    against prefill at 2e-4 (``tests/test_models.py``), the kernels inside
    the model against the plain decode path."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    cfg = dataclasses.replace(get_config(MODEL), n_layers=5,
                              dtype="float32")
    gen = torch.Generator(device=dev).manual_seed(64)
    params = T.init_params(cfg, generator=gen, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, EXACT_S), generator=gen,
                         device=dev)
    pre = T.forward(params, cfg, toks, last_only=True)[:, 0]
    state = T.init_decode_state(cfg, 2, EXACT_S, dev)
    for t in range(EXACT_S):
        dec, state = T.decode_step(params, cfg, toks[:, t], t, state)
    V = cfg.vocab
    err = float((dec[:, :V] - pre[:, :V]).abs().max())
    print(f"model exact: {MODEL} fp32 at d={cfg.d_model}, {cfg.n_layers} "
          f"layers {T.layer_kinds(cfg)}, B=2 S={EXACT_S}: decode against "
          f"prefill max abs err {err:.3g} (logits up to "
          f"{float(pre[:, :V].abs().max()):.3f})")
    if not torch.allclose(dec[:, :V], pre[:, :V], atol=2e-4, rtol=2e-4):
        fail(f"model exact: fp32 decode differs from prefill by {err}")
    del params, state
    torch.cuda.empty_cache()


def phase_model(dev, rows, measured=None):
    """Phase 3: the model substrate — the two kernels against their plain
    versions, the smoke configs card against CPU, recurrentgemma-9b at
    full width (the slice's path) and its fp32 exactness check."""
    import torch
    t0 = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 stays fp32
    try:
        model_kernels(dev, rows)
        model_smoke_configs(dev)
        model_path(dev, rows, measured)
        model_exact(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    print(f"model phase {time.perf_counter() - t0:.1f} s")


#: launches of ``flash_attention`` per bf16 forward of each of phase 11's
#: paths: granite-moe's 24 causal layers (S=2048 tiles); none for RWKV;
#: whisper's 12 decoder layers (S=256), while its encoder and
#: cross-attention over 1500 frames (not a multiple of 128) take
#: ``ref.chunked_attention``'s route, as the reference's routing does.
FAMILY_LAUNCHES = {"granite-moe-1b-a400m": 24, "rwkv6-3b": 0,
                   "whisper-small": 12}


def labelled_split(fn, labels):
    """Profile one call of ``fn`` (after one to warm up) with a profiler
    range around each call of the functions ``labels`` names ({label:
    (module, attribute)}; patched for the call, restored after): (the
    device ms of every kernel and memset, {label: device ms of the kernels
    launched inside its ranges}, {device entry: (ms, count)})."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                record_function)
    saved = []
    for label, (mod, attr) in labels.items():
        f = getattr(mod, attr)

        def ranged(*a, _f=f, _label=label, **k):
            with record_function(_label):
                return _f(*a, **k)

        saved.append((mod, attr, f))
        setattr(mod, attr, ranged)
    try:
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for mod, attr, f in saved:
            setattr(mod, attr, f)
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    events = prof.events()
    ranged_ms = {label: sum(ev.device_time_total for ev in events
                            if ev.name == label and ev.device_type == cpu
                            ) / 1e3 for label in labels}
    entries = {}
    for ev in events:
        if ev.device_type == cuda and ev.name not in labels:
            ms, n = entries.get(ev.name, (0.0, 0))
            entries[ev.name] = (ms + ev.self_device_time_total / 1e3, n + 1)
    return sum(ms for ms, _ in entries.values()), ranged_ms, entries


def wall_share(fn, mod, attr: str):
    """(host wall s of one call of ``fn``, the wall s spent inside calls
    of ``mod.attr``), each such call bracketed by device syncs (patched
    for the call, restored after)."""
    import torch
    inner = getattr(mod, attr)
    spent = 0.0

    def timed(*a, **k):
        nonlocal spent
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        torch.cuda.synchronize()
        spent += time.perf_counter() - t0
        return out

    setattr(mod, attr, timed)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, spent
    finally:
        setattr(mod, attr, inner)


def family_path(dev, arch: str, B: int, S: int, rows) -> None:
    """One model family at its published widths in bf16, parameters drawn
    on the card: prefill ``forward(last_only=True)`` at B x S (whisper
    over its 1500 frames), a warm-up then the best of 3, with exactly
    ``FAMILY_LAUNCHES[arch]`` tensor-core ``flash_attention`` launches a
    forward; then ``PREFILL_B`` requests served through ``decode_step``
    (``PROMPT``-token prompts, held against the prefill of the same
    prompts, the bf16 gap printed, not gated; whisper's cross K/V computed
    once), and ``NEW_TOKENS`` greedy tokens.  The launch counts are set
    to 0 just before and read just after."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import models as MK
    from repro_torch.models import moe as tmoe
    from repro_torch.models import rwkv6 as trw
    from repro_torch.models import transformer as T
    cfg = get_config(arch)
    gen = torch.Generator(device=dev).manual_seed(66)
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    nbytes = tree_bytes(params)
    print(f"family {arch} (published config: {cfg.n_layers} layers"
          + (f" + {cfg.encoder.n_layers} encoder layers"
             if cfg.encoder is not None else "")
          + f", d={cfg.d_model}, pattern {cfg.block_pattern}"
          + (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of "
             f"d_ff {cfg.moe.expert_d_ff}" if cfg.moe is not None else "")
          + f", vocab {cfg.vocab}) bf16: {nbytes} parameter bytes "
          f"({nbytes / 1e9:.2f} GB; the config's param_count x 2 bytes "
          f"{2 * cfg.param_count() / 1e9:.2f} GB) drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    toks = torch.randint(0, cfg.vocab, (B, S), generator=gen, device=dev)
    frames = None
    if cfg.encoder is not None:
        frames = torch.randn((B, cfg.encoder.n_frames, cfg.d_model),
                             generator=gen, device=dev).to(torch.bfloat16)
    per_fwd = FAMILY_LAUNCHES[arch]
    torch.cuda.synchronize()
    MK.reset_launches()
    n_fwd = 0

    def prefill(tokens=toks):
        nonlocal n_fwd
        n_fwd += 1
        return T.forward(params, cfg, tokens, frames=frames, last_only=True)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lg = prefill()
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        lg = prefill()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    if lg.shape != (B, 1, cfg.padded_vocab) or \
            not bool(lg[..., :cfg.vocab].isfinite().all()):
        fail(f"family {arch}: prefill logits {tuple(lg.shape)} not finite")
    print(f"family {arch} prefill: B={B} S={S}"
          + (f" over {cfg.encoder.n_frames} frames"
             if frames is not None else "")
          + f" forward(last_only=True) best of 3 {best * 1e3:.3f} ms "
          f"({B * S / best:.1f} tokens/s; first call {first * 1e3:.1f} "
          f"ms); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # -- four requests: prompt through decode_step, then greedy decode ----
    prompts = toks[:, :PROMPT]
    cross = None
    t0 = time.perf_counter()
    if frames is not None:          # once per batch, for every step
        cross = T.cross_kv(params, cfg, T.encode(params, cfg, frames))
    torch.cuda.synchronize()
    t_cross = time.perf_counter() - t0
    state = T.init_decode_state(cfg, B, PROMPT + NEW_TOKENS, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(PROMPT):
        dec, state = T.decode_step(params, cfg, prompts[:, t], t, state,
                                   cross=cross)
    torch.cuda.synchronize()
    t_prompt = time.perf_counter() - t0
    pre = prefill(prompts)[:, 0]
    V = cfg.vocab
    gap = float((dec[:, :V] - pre[:, :V]).abs().max())
    top1 = int((dec[:, :V].argmax(-1) == pre[:, :V].argmax(-1)).sum())
    tok = dec[:, :V].argmax(-1)
    out = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(NEW_TOKENS):
        out.append(tok)
        lg_d, state = T.decode_step(params, cfg, tok, PROMPT + i, state,
                                    cross=cross)
        tok = lg_d[:, :V].argmax(-1)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    if torch.stack(out, 1).shape != (B, NEW_TOKENS) or \
            not bool(lg_d[:, :V].isfinite().all()):
        fail(f"family {arch}: greedy decode produced no finite logits")
    counts = dict(MK.launches)
    tc = MK.symbol_launches.get("models_flash_attention_tc", 0)
    simt = MK.symbol_launches.get("models_flash_attention", 0)
    print(f"family {arch} serve: {B} prompts of {PROMPT} tokens through "
          f"decode_step in {t_prompt:.3f} s ({B * PROMPT / t_prompt:.1f} "
          f"tokens/s)" + (f", the cross K/V once in {t_cross * 1e3:.1f} ms"
                          if cross is not None else "")
          + f"; bf16 gap to forward(last_only=True) {gap:.4f} (logits up "
          f"to {float(pre[:, :V].abs().max()):.3f}; not gated), top-1 "
          f"agreement {top1}/{B}; decode {NEW_TOKENS} greedy tokens in "
          f"{t_dec:.3f} s ({t_dec / NEW_TOKENS * 1e3:.2f} ms per step, "
          f"{B * NEW_TOKENS / t_dec:.1f} tokens/s)")
    print(f"family {arch}: launches {json.dumps(counts)} over {n_fwd} "
          f"forwards ({per_fwd} flash_attention each; decode launches "
          f"none), tensor-core entries {tc}, CUDA-core {simt}")
    if counts != {"flash_attention": per_fwd * n_fwd, "rglru_scan": 0} \
            or tc != per_fwd * n_fwd or simt:
        fail(f"family {arch}: launches {counts}, tensor-core {tc}, "
             f"CUDA-core {simt}; expected {per_fwd} tensor-core launches "
             f"per forward")
    rows["flash_attention"]["launches"] += counts["flash_attention"]

    if cfg.moe is not None:          # where one prefill's device time goes
        total, ranged, entries = labelled_split(
            prefill, {"moe_block": (T, "moe_block"),
                      "expert_bmm": (tmoe, "qeinsum")})
        attn = [(ms, n) for k, (ms, n) in entries.items()
                if "flash_attention" in k]
        attn_ms = sum(ms for ms, _ in attn)
        attn_n = sum(n for _, n in attn)
        if attn_n and attn_n < per_fwd:   # dropped records: mean x calls
            attn_ms *= per_fwd / attn_n
        moe_ms, bmm_ms = ranged["moe_block"], ranged["expert_bmm"]
        top = sorted(entries.items(), key=lambda kv: -kv[1][0])[:4]
        if total == 0:
            print(f"family {arch} prefill device time: not measured (the "
                  f"profiler recorded none)")
        else:
            print(f"family {arch} prefill device time: {total:.3f} ms of "
                  f"{best * 1e3:.3f} ms wall (idle "
                  f"{100 * (1 - total / (best * 1e3)):.1f}%): MoE blocks "
                  f"{moe_ms:.3f} ms (expert bmm {bmm_ms:.3f}; router, "
                  f"dispatch, the swiglu's elementwise and combine "
                  f"{moe_ms - bmm_ms:.3f}), flash_attention {attn_ms:.3f} "
                  f"ms ({attn_n} of {per_fwd} entries recorded), the rest "
                  f"{total - moe_ms - attn_ms:.3f} ms; longest: "
                  + "; ".join(f"{k[:40]} {ms:.3f} ms x{n}"
                              for k, (ms, n) in top))
    if "rwkv" in cfg.block_pattern:  # the time mix's share of a prefill
        wall, inside = wall_share(prefill, trw, "_time_mix")
        print(f"family {arch} prefill: the time mix (its projections and "
              f"the chunked WKV scan, {-(-S // trw.WKV_CHUNK)} carry steps "
              f"a layer) {inside * 1e3:.3f} ms of "
              f"{wall * 1e3:.3f} ms wall ({100 * inside / wall:.1f}%, each "
              f"call between device syncs)")
    where_the_time_goes(f"family {arch} decode_step", lambda: T.decode_step(
        params, cfg, tok, PROMPT + NEW_TOKENS - 1, state, cross=cross),
        t_dec / NEW_TOKENS, required=False)
    del params, state, lg, pre, dec, lg_d, cross, frames
    torch.cuda.empty_cache()


def family_attention(dev) -> None:
    """``flash_attention`` at granite-moe's prefill shape ([4, 16, 2048,
    64] queries over [4, 8, 2048, 64], causal, bf16) against its plain
    version (allclose at 2e-2) and timed beside it and
    ``scaled_dot_product_attention`` with the same mask, with its bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import models as MK
    from repro_torch.kernels import ref
    g = torch.Generator(device=dev).manual_seed(67)
    B_, Hq, Hkv, S_, D = 4, 16, 8, 2048, 64
    q, k, v = (torch.randn((B_, h, S_, D), generator=g,
                           device=dev).bfloat16() for h in (Hq, Hkv, Hkv))
    got, want = MK.flash_attention(q, k, v), ref.flash_attention_ref(q, k, v)
    err = float((got.float() - want.float()).abs().max())
    if not torch.allclose(got.float(), want.float(),
                          atol=ATTN_TOL["bfloat16"],
                          rtol=ATTN_TOL["bfloat16"]):
        fail(f"flash_attention at granite-moe's shape: max abs err {err}")
    # between CUDA events (late in a whole run the profiler has recorded
    # no device time); each call is long, so the host adds no gaps.
    ms = wall_ms(lambda: MK.flash_attention(q, k, v), MODEL_ITERS, 2)
    plain_ms = wall_ms(lambda: ref.flash_attention_ref(q, k, v),
                       MODEL_ITERS, 2)
    lib_ms = wall_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), MODEL_ITERS, 2)
    pairs = attention_pairs(S_, S_, True, None)
    nops = 4 * D * B_ * Hq * pairs
    nbytes = 2 * (2 * q.numel() + 2 * k.numel())
    bound = max(nops / TENSOR_CORE_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)
    print(f"kernel flash_attention at granite-moe's [4,16,2048,64]/"
          f"[4,8,2048,64] causal bf16: allclose (max abs err {err:g}); "
          f"between CUDA events, {MODEL_ITERS} calls back to back: "
          f"{ms * 1e3:.3f} us ({nops / ms / 1e9:.1f} TFLOP/s, "
          f"{100 * bound * 1e3 / ms:.1f}% of its bound "
          f"{bound * 1e6:.3f} us: {nops} flops, {nbytes} bytes), plain "
          f"{plain_ms * 1e3:.3f} us, scaled_dot_product_attention "
          f"{lib_ms * 1e3:.3f} us ({lib_ms / ms:.3f}x the kernel's time)")
    del q, k, v, got, want
    torch.cuda.empty_cache()


def family_exact(dev) -> None:
    """fp32 at full width with the depth cut to ``FAMILY_EXACT_LAYERS``
    (whisper: as many encoder layers too, over its 1500 frames): decode
    against prefill at 2e-4, MoE at capacity 8.0 (no slot dropped by
    either)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    for arch, _, _ in FAMILY_PATHS:
        cfg = get_config(arch)
        cfg = dataclasses.replace(
            cfg, n_layers=FAMILY_EXACT_LAYERS, dtype="float32",
            moe=cfg.moe and dataclasses.replace(cfg.moe,
                                                capacity_factor=8.0),
            encoder=cfg.encoder and dataclasses.replace(
                cfg.encoder, n_layers=FAMILY_EXACT_LAYERS))
        gen = torch.Generator(device=dev).manual_seed(68)
        params = T.init_params(cfg, generator=gen, device=dev)
        toks = torch.randint(0, cfg.vocab, (2, FAMILY_EXACT_S),
                             generator=gen, device=dev)
        frames = cross = None
        if cfg.encoder is not None:
            frames = torch.randn((2, cfg.encoder.n_frames, cfg.d_model),
                                 generator=gen, device=dev)
            cross = T.cross_kv(params, cfg, T.encode(params, cfg, frames))
        pre = T.forward(params, cfg, toks, frames=frames,
                        last_only=True)[:, 0]
        state = T.init_decode_state(cfg, 2, FAMILY_EXACT_S, dev)
        for t in range(FAMILY_EXACT_S):
            dec, state = T.decode_step(params, cfg, toks[:, t], t, state,
                                       cross=cross)
        V = cfg.vocab
        err = float((dec[:, :V] - pre[:, :V]).abs().max())
        print(f"family exact: {arch} fp32 at d={cfg.d_model}, "
              f"{cfg.n_layers} layers"
              + (f" + {cfg.encoder.n_layers} encoder layers over "
                 f"{cfg.encoder.n_frames} frames" if frames is not None
                 else "")
              + (", capacity 8.0" if cfg.moe is not None else "")
              + f", B=2 S={FAMILY_EXACT_S}: decode against prefill max abs "
              f"err {err:.3g} (logits up to "
              f"{float(pre[:, :V].abs().max()):.3f})")
        if not torch.allclose(dec[:, :V], pre[:, :V], atol=2e-4, rtol=2e-4):
            fail(f"family exact: {arch} fp32 decode differs from prefill "
                 f"by {err}")
        del params, state, cross
        torch.cuda.empty_cache()


def family_moe_layer(dev) -> None:
    """One granite-moe layer in fp32 over ``MOE_LAYER_T`` tokens, card
    against CPU on the same parameters and input: ``dispatch_positions``
    from the same expert indices bit for bit, the block's output and aux
    loss allclose at 2e-4; the dropped slots printed."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    from repro_torch.models import moe as tmoe
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              dtype="float32")
    m = cfg.moe
    gen = torch.Generator(device="cpu").manual_seed(69)
    p = tmoe.moe_params(gen, cfg, torch.float32, "cpu")
    x = torch.randn((4, MOE_LAYER_T // 4, cfg.d_model), generator=gen)
    p_g, x_g = card_params(p, dev), x.to(dev)

    def experts(pp, xx):
        xn = L.rms_norm(xx, pp["ln"]).reshape(-1, cfg.d_model)
        probs = torch.softmax(xn.float() @ pp["router"], dim=-1)
        return torch.topk(probs, m.top_k, dim=-1).indices.reshape(-1)

    def one_hot_positions(flat_e):
        """The reference's slot positions: a cumsum down the one-hot
        ``[T * k, E]`` plane."""
        onehot = torch.nn.functional.one_hot(flat_e, m.n_experts)
        return (onehot.cumsum(0) - onehot).gather(1, flat_e[:, None])[:, 0]

    flat_g, flat_c = experts(p_g, x_g), experts(p, x)
    cap = tmoe.capacity(MOE_LAYER_T, cfg)
    got = tmoe.dispatch_positions(flat_g, m.n_experts, cap)
    want = tmoe.dispatch_positions(flat_g.cpu(), m.n_experts, cap)
    if not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)) or \
            not torch.equal(got[0], one_hot_positions(flat_g)):
        fail("family MoE layer: dispatch_positions on the card differ "
             "from the CPU's or from the one-hot cumsum's")
    sort_ms = wall_ms(lambda: tmoe.dispatch_positions(
        flat_g, m.n_experts, cap), 20, 2)
    hot_ms = wall_ms(lambda: one_hot_positions(flat_g), 20, 2)
    print(f"family MoE layer: dispatch_positions over {flat_g.numel()} "
          f"slots, between CUDA events, 20 calls back to back: the stable "
          f"sort {sort_ms * 1e3:.3f} us a call, the reference's one-hot "
          f"cumsum {hot_ms * 1e3:.3f} us")
    dropped = int((~want[1]).sum())
    y_g, aux_g = tmoe.moe_block(p_g, cfg, x_g)
    y_c, aux_c = tmoe.moe_block(p, cfg, x)
    err = float((y_g.cpu() - y_c).abs().max())
    routed = int((flat_g.cpu() != flat_c).sum())
    print(f"family MoE layer: granite-moe fp32, T={MOE_LAYER_T}, "
          f"{m.n_experts} experts top-{m.top_k}, capacity {cap}: "
          f"dispatch_positions card == CPU bit for bit over "
          f"{flat_g.numel()} slots, {dropped} dropped; expert choices "
          f"differing card vs CPU {routed}; output max abs err {err:.3g}, "
          f"aux {float(aux_g):.6f} vs {float(aux_c):.6f}")
    if not (torch.allclose(y_g.cpu(), y_c, atol=2e-4, rtol=2e-4)
            and torch.allclose(aux_g.cpu(), aux_c, atol=2e-4, rtol=2e-4)):
        fail(f"family MoE layer: the block on the card differs from the "
             f"CPU's by {err}")
    q8 = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, dispatch_int8=True))
    y_g, _ = tmoe.moe_block(p_g, q8, x_g)
    y_c, _ = tmoe.moe_block(p, q8, x)
    diff = (y_g.cpu() - y_c).abs()
    err = float(diff.max())
    past = int((diff > 2e-4).sum())
    print(f"family MoE layer with dispatch_int8: output max abs err "
          f"{err:.3g}, {past} of {diff.numel()} elements past 2e-4 (codes "
          f"that round the other way; at most 1% of them, none past "
          f"{2 * Q8_TOL:g}, two codes of a row of largest value 2.54)")
    if past > diff.numel() // 100 or err > 2 * Q8_TOL:
        fail(f"family MoE layer: the int8 dispatch on the card differs "
             f"from the CPU's by {err} in {past} elements")
    del p_g, x_g, y_g
    torch.cuda.empty_cache()


def phase_families(dev, rows) -> None:
    """Phase 11: the model families (MoE, RWKV6, encoder-decoder) — (a)
    the four smoke configs and granite-moe with the int8 dispatch, card
    against CPU; (b) granite-moe-1b-a400m, rwkv6-3b and whisper-small at
    their published widths in bf16 (``family_path``), and
    ``flash_attention`` at granite-moe's shape; (c) the fp32 exactness
    check; (d) one granite-moe layer card against CPU."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 stays fp32
    try:
        moe = get_config("granite-moe-1b-a400m", smoke=True)
        model_smoke_configs(dev, FAMILY_ARCHS, extra=[(
            "granite-moe-1b-a400m dispatch_int8", dataclasses.replace(
                moe, moe=dataclasses.replace(moe.moe, dispatch_int8=True)),
            Q8_TOL)])
        for arch, B, S in FAMILY_PATHS:
            family_path(dev, arch, B, S, rows)
        family_attention(dev)
        family_exact(dev)
        family_moe_layer(dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    print(f"model families phase {time.perf_counter() - t0:.1f} s (budget "
          f"{FAMILY_BUDGET_S} s)")


def _grads_close(label: str, got, want, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    """Fail unless every leaf of two trees (card, CPU) is allclose; the
    largest abs error."""
    import torch
    from repro_torch.tree import leaves_with_path
    worst = 0.0
    for (path, g), (_, w) in zip(leaves_with_path(got),
                                 leaves_with_path(want)):
        g = g.detach().cpu()
        if g.shape != w.shape or g.dtype != w.dtype:
            fail(f"{label}: leaf {path} {g.dtype} {tuple(g.shape)} against "
                 f"{w.dtype} {tuple(w.shape)}")
        err = float((g.float() - w.float()).abs().max()) if g.numel() else 0.
        worst = max(worst, err)
        if not torch.allclose(g, w, atol=atol, rtol=rtol):
            fail(f"{label}: leaf {'/'.join(map(str, path))} differs, max "
                 f"abs err {err}")
    return worst


def profiled(fn):
    """(``fn()``, its wall ms, device ms, device operations, [(name, ms)]
    longest first) of one call under the profiler, from its raw events:
    the device entries' durations summed by name.  A train step is about
    2.6e5 device operations, whose ``key_averages()`` took minutes; the
    raw events take seconds.  The wall is the call's to its
    synchronisation, without the profiler's own stop; device ms is None
    if no device time was recorded."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    n = 0
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            by_name[ev.name()] = by_name.get(ev.name(), 0) + \
                ev.duration_ns() / 1e6
            n += 1
    rows = sorted(by_name.items(), key=lambda r: -r[1])
    return out, wall, (sum(by_name.values()) if n else None), n, rows


def train_exact(dev) -> None:
    """Card against CPU in fp32, on the same parameters and batch with
    ``use_kernel=False``: loss and every gradient leaf of the ten smoke
    configs and of smollm-360m at full width cut to 2 layers; one AdamW
    update on the same gradients; the int8 MoE wire's gradients."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as tmoe
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.train_step import _value_and_grad
    from repro_torch.tree import tree_map
    cases = [(arch, get_config(arch, smoke=True), 2, 16)
             for arch in SMOKE_ARCHS]
    full = get_config(TRAIN_ARCH)
    cases.append((f"{TRAIN_ARCH} d={full.d_model} {TRAIN_EXACT_LAYERS} "
                  f"layers", dataclasses.replace(
                      full, n_layers=TRAIN_EXACT_LAYERS, dtype="float32",
                      remat=False), TRAIN_EXACT_B, TRAIN_EXACT_S))
    for label, cfg, Bt, St in cases:
        t0 = time.perf_counter()
        gen = torch.Generator(device="cpu").manual_seed(71)
        cpu_p = T.init_params(cfg, generator=gen, device="cpu")
        mb = {"tokens": torch.randint(0, cfg.vocab, (Bt, St), generator=gen,
                                      dtype=torch.int32),
              "targets": torch.randint(0, cfg.vocab, (Bt, St),
                                       generator=gen, dtype=torch.int32)}
        if cfg.encoder is not None:
            mb["frames"] = torch.randn((Bt, cfg.encoder.n_frames,
                                        cfg.d_model), generator=gen)
        lc, _, gc = _value_and_grad(cfg, cpu_p, mb)
        lg, _, gg = _value_and_grad(cfg, card_params(cpu_p, dev),
                                    card_params(mb, dev))
        if abs(float(lg) - float(lc)) > LOSS_TOL:
            fail(f"train exact {label}: loss {float(lg)} on the card, "
                 f"{float(lc)} on the CPU")
        worst = _grads_close(f"train exact {label}", gg, gc)
        print(f"train exact {label} (fp32, B={Bt} S={St}): loss "
              f"{float(lg):.6f} card, {float(lc):.6f} CPU; every gradient "
              f"leaf card == CPU at atol {GRAD_ATOL:g} rtol {GRAD_RTOL:g}, "
              f"max abs err {worst:.3g}; {time.perf_counter() - t0:.1f} s")
    # one AdamW update on the last case's CPU gradients, from non-zero
    # moments at step 4, on both devices.
    st = adamw.OptState(torch.tensor(4, dtype=torch.int32),
                        tree_map(lambda g: 0.5 * g, gc),
                        tree_map(lambda g: g * g, gc))
    ocfg = adamw.OptimConfig(peak_lr=0.01, warmup_steps=3, total_steps=20)
    pc, sc, oc = adamw.update(ocfg, st, cpu_p, gc)
    pg, sg, og = adamw.update(ocfg, tree_map(lambda t: t.to(dev), st),
                              card_params(cpu_p, dev), card_params(gc, dev))
    if int(sg.step) != int(sc.step) or sg.step.dtype != torch.int32:
        fail("train exact adamw: step differs")
    for k in ("lr", "grad_norm"):
        if not torch.allclose(og[k].cpu(), oc[k], atol=0, rtol=1e-5):
            fail(f"train exact adamw: {k} {float(og[k])} against "
                 f"{float(oc[k])}")
    errs = [_grads_close("train exact adamw params", pg, pc, 1e-6, 1e-5),
            _grads_close("train exact adamw m", sg.m, sc.m, 1e-7, 1e-5),
            _grads_close("train exact adamw v", sg.v, sc.v, 1e-9, 1e-5)]
    print(f"train exact adamw update ({label}): step {int(sg.step)}, lr "
          f"{float(og['lr']):.6g}, grad_norm {float(og['grad_norm']):.6g}; "
          f"params, m, v card == CPU, max abs err "
          f"{', '.join(f'{e:.3g}' for e in errs)}")
    # the int8 MoE wire: its two backward functions bit for bit, then the
    # whole smoke model's gradients at the CPU tests' tolerances (3.0e-7
    # measured on an H100; a code that rounded the other way between the
    # card and the CPU would move a slot by 1/127 of its row and show
    # here as a failure, not be absorbed by a looser bound).
    moe = get_config("granite-moe-1b-a400m", smoke=True)
    rng = torch.Generator(device="cpu").manual_seed(73)
    E, cap, d, n = 8, 6, 64, 64
    flat_e = torch.randint(0, E, (n,), generator=rng)
    pos, keep, safe = tmoe.dispatch_positions(flat_e, E, cap)
    gbuf = torch.randn((E, cap, d), generator=rng)
    gslot = torch.randn((n, d), generator=rng)
    for dv in (dev, "cpu"):
        src = torch.randn((n, d), generator=torch.Generator(
            device="cpu").manual_seed(74)).to(dv).requires_grad_(True)
        ob = torch.randn((E, cap, d), generator=torch.Generator(
            device="cpu").manual_seed(75)).to(dv).requires_grad_(True)
        a = [t.to(dv) for t in (flat_e, pos, keep, safe)]
        buf = tmoe._dispatch_q8(src, a[0], a[1], a[2], E, cap)
        out = tmoe._combine_q8(ob, a[0], a[3], a[2])
        g1, = torch.autograd.grad(buf, src, gbuf.to(dv))
        g2, = torch.autograd.grad(out, ob, gslot.to(dv))
        if dv == "cpu":
            if not (torch.equal(g1, wire[0]) and torch.equal(g2, wire[1])):
                fail("train exact int8 wire: the backward differs between "
                     "the card and the CPU")
        else:
            wire = (g1.cpu(), g2.cpu())
    cfg8 = dataclasses.replace(moe, moe=dataclasses.replace(
        moe.moe, dispatch_int8=True))
    gen = torch.Generator(device="cpu").manual_seed(76)
    cpu_p = T.init_params(cfg8, generator=gen, device="cpu")
    toks = torch.randint(0, moe.vocab, (2, 16), generator=gen,
                         dtype=torch.int32)
    mb = {"tokens": toks, "targets": toks.roll(-1, 1)}
    lc, _, gc = _value_and_grad(cfg8, cpu_p, mb)
    lg, _, gg = _value_and_grad(cfg8, card_params(cpu_p, dev),
                                card_params(mb, dev))
    worst = _grads_close("train exact int8 MoE", gg, gc)
    if abs(float(lg) - float(lc)) > LOSS_TOL:
        fail(f"train exact int8 MoE: loss {float(lg)} against {float(lc)}")
    print(f"train exact int8 MoE wire: _DispatchQ8/_CombineQ8 backward card "
          f"== CPU bit for bit ({int((~keep).sum())} of {n} slots dropped); "
          f"granite-moe smoke dispatch_int8 gradients card == CPU at atol "
          f"{GRAD_ATOL:g} rtol {GRAD_RTOL:g}, max abs err {worst:.3g}, loss "
          f"{float(lg):.6f} "
          f"card {float(lc):.6f} CPU")


def train_guard(dev) -> None:
    """The model kernels refuse an input that requires grad while grad
    mode is on (their output would be cut off from the graph), and run
    under ``torch.no_grad()``."""
    import torch
    from repro_torch.kernels import models as MK
    q = torch.randn((1, 2, 128, 64), device=dev)
    x = torch.randn((1, 128, 128), device=dev)
    a = torch.rand((1, 128, 128), device=dev)
    calls = {"flash_attention": lambda t: MK.flash_attention(t, t, t),
             "rglru_scan": lambda t: MK.rglru_scan(t, a)}
    for name, call in calls.items():
        t = (q if name == "flash_attention" else x).clone()
        t.requires_grad_(True)
        try:
            call(t)
        except RuntimeError as e:
            if "use_kernel=False" not in str(e):
                fail(f"train guard {name}: unexpected error {e}")
        else:
            fail(f"train guard {name}: a CUDA input that requires grad "
                 f"was not refused")
        with torch.no_grad():
            call(t)
    torch.cuda.synchronize()
    print("train guard: flash_attention and rglru_scan refuse a CUDA input "
          "that requires grad (training takes use_kernel=False) and run "
          "under torch.no_grad()")


def train_resume(dev) -> None:
    """``Trainer`` on the card (smollm smoke): a run cut by ``fail_at`` and
    restarted from its checkpoint ends with the parameters, moments and
    data step of an uninterrupted run, bit for bit, as
    ``tests/test_substrates.py::test_failure_resume_bitwise`` holds the
    reference's."""
    import shutil
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimConfig
    from repro_torch.train import Trainer, TrainerConfig
    from repro_torch.tree import leaves
    cfg = get_config(TRAIN_ARCH, smoke=True)
    root = tempfile.mkdtemp(prefix="train_resume_",
                            dir=os.path.join(HERE, "build"))
    ckdir = os.path.join(root, "ck")

    def trainer():
        params = T.init_params(cfg, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)
        return Trainer(cfg, OptimConfig(peak_lr=1e-3, warmup_steps=2,
                                        total_steps=10),
                       TrainerConfig(steps=10, ckpt_every=4, ckpt_dir=ckdir),
                       None, params, DataConfig(cfg.vocab, 16, 4),
                       device=dev)

    try:
        t1 = trainer()
        try:
            t1.run(fail_at=6)
        except RuntimeError as e:
            print(f"train resume: {e}")
        else:
            fail("train resume: fail_at did not stop the run")
        t1.saver.wait()
        t2 = trainer()
        t2.run()
        shutil.rmtree(ckdir)
        t3 = trainer()
        t3.run()
        same = all(torch.equal(a, b) for a, b in zip(leaves(t2.state),
                                                     leaves(t3.state)))
        if not same or t2.metrics_log[0]["step"] != 4:
            fail("train resume: the resumed run's state differs from the "
                 "uninterrupted run's")
        print(f"train resume ({cfg.name}, 10 steps, checkpoints every 4): "
              f"cut at step 6, resumed from step "
              f"{t2.metrics_log[0]['step']}: params, moments and data step "
              f"bit-identical to an uninterrupted run "
              f"({len(leaves(t3.state))} leaves); final loss "
              f"{t3.metrics_log[-1]['loss']:.6f}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def train_path(dev, measured=None) -> None:
    """smollm-360m whole in bf16 with full remat: a warm-up step and
    ``TRAIN_STEPS`` timed steps of ``train_step`` on ``SyntheticPipeline``
    batches (no kernel launched: the training path is the plain one);
    then the whole ``TrainState`` saved, verified and loaded back on the
    card, bit for bit.  The best step's seconds go to
    ``measured["train_step_s"]`` (phase 14)."""
    import shutil
    import tempfile

    import torch
    from repro_torch import convert
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.kernels import models as MK
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_state, train_step
    from repro_torch.tree import leaves, leaves_with_path
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.empty_cache()
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    state = init_state(params)
    del params
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab, TRAIN_S, TRAIN_BATCH),
                             device=dev)
    print(f"train: {cfg.name} {cfg.dtype} at its published widths and "
          f"depth ({cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, vocab {cfg.vocab} padded "
          f"to {cfg.padded_vocab}, tied, remat {cfg.remat_policy}): "
          f"{n_params:,} parameters, {tree_bytes(state.params):,} bytes, "
          f"moments {tree_bytes(state.opt.m) + tree_bytes(state.opt.v):,} "
          f"bytes; batches of {TRAIN_BATCH} x {TRAIN_S} as "
          f"{TRAIN_MICRO} micro-batches")

    def step(st):
        batch = pipe.batch(int(st.data_step))
        return train_step(cfg, ocfg, TRAIN_MICRO, st, batch)

    MK.reset_launches()
    # the warm-up step runs under the profiler (a profiled step takes
    # about 10 s more of the host; a warm-up took 0.2 s more than a timed
    # step unprofiled), so the timed steps run without it.
    (state, m), wall, busy, n_ops, split = profiled(lambda: step(state))
    print(f"train warm-up step (profiled): loss {float(m['loss']):.6f} "
          f"grad_norm {float(m['grad_norm']):.6f} lr "
          f"{float(m['lr']):.6g}, {wall / 1e3:.3f} s")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        state, m = step(state)
        loss = float(m["loss"])
        times.append(time.perf_counter() - t0)
        if not torch.isfinite(m["grad_norm"]) or loss != loss:
            fail(f"train: step {int(state.data_step)} loss {loss}")
        print(f"train step {int(state.data_step) - 1}: loss {loss:.6f} "
              f"grad_norm {float(m['grad_norm']):.6f} lr "
              f"{float(m['lr']):.6g}, {times[-1]:.3f} s")
    peak = torch.cuda.max_memory_allocated()
    if sum(MK.launches.values()):
        fail(f"train: the training path launched kernels "
             f"{dict(MK.launches)}; it takes use_kernel=False")
    tokens = TRAIN_BATCH * TRAIN_S
    best = min(times)
    if measured is not None:
        measured["train_step_s"] = best
    print(f"train: {TRAIN_STEPS} steps in {sum(times):.3f} s (budget "
          f"{TRAIN_BUDGET_S} s), {sum(times) / len(times):.3f} s a step "
          f"(best {best:.3f}), {tokens / best:,.1f} tokens/s at the best, "
          f"peak memory {peak:,} bytes, no kernel launched")
    print(f"train: with each attention query block recomputed in the "
          f"backward, peak {peak:,} bytes against {TRAIN_PEAK_BEFORE:,} "
          f"before ({peak / TRAIN_PEAK_BEFORE:.3f}x); step {min(times):.3f}"
          f"-{max(times):.3f} s against {TRAIN_STEP_BEFORE[0]:.3f}-"
          f"{TRAIN_STEP_BEFORE[1]:.3f} s before")
    if peak >= TRAIN_PEAK_BEFORE:
        fail(f"train: peak {peak:,} bytes, not below the "
             f"{TRAIN_PEAK_BEFORE:,} of a backward that kept every tile")
    if sum(times) > TRAIN_BUDGET_S:
        fail(f"train: {TRAIN_STEPS} steps took {sum(times):.1f} s, over "
             f"{TRAIN_BUDGET_S} s")
    if busy is None:
        print("train warm-up step (profiled): device time not measured "
              "(the profiler recorded none)")
    else:
        print(f"train warm-up step (profiled): device {busy:.3f} ms in "
              f"{n_ops} ops of {wall:.3f} ms wall (idle "
              f"{100 * (1 - busy / wall):.1f}%); longest: "
              + "; ".join(f"{k[:60]} {ms:.3f} ms" for k, ms in split[:6]))

    root = tempfile.mkdtemp(prefix="train_ckpt_",
                            dir=os.path.join(HERE, "build"))
    try:
        path = ckpt.step_path(root, int(state.data_step))
        stacked = convert.stack_train_state(state, cfg)
        t0 = time.perf_counter()
        saver = ckpt.AsyncCheckpointer()
        saver.save(path, stacked, meta={"step": int(state.data_step),
                                        "arch": cfg.name})
        t_copy = time.perf_counter() - t0
        saver.wait()
        t_save = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        ok = ckpt.verify(path)
        t_verify = time.perf_counter() - t0
        if not ok:
            fail("train checkpoint: verify failed")
        t0 = time.perf_counter()
        back, meta = ckpt.load(path, stacked, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        restored = convert.unstack_train_state(back, cfg)
        pairs = list(zip(leaves_with_path(restored), leaves(state)))
        for (p, a), b in pairs:
            if a.dtype != b.dtype or a.device != b.device or \
                    not torch.equal(a, b):
                fail(f"train checkpoint: leaf {p} differs after the round "
                     f"trip")
        print(f"train checkpoint: the whole TrainState ({len(pairs)} "
              f"leaves, {size:,} bytes) saved in {t_save:.3f} s (host copy "
              f"{t_copy:.3f} s in save(), the rest on the thread), verified "
              f"in {t_verify:.3f} s, loaded on the card in {t_load:.3f} s; "
              f"every leaf bit-identical; meta {json.dumps(meta)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def scan_ops(x, a) -> int:
    """The aten operations one call of the plain RG-LRU scan dispatches
    on x, a."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.kernels import ref

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    with Count():
        ref.rglru_scan_ref(x, a)
    return Count.n


def train_hybrid(dev) -> None:
    """recurrentgemma-9b trains on the card: its published widths, one
    superlayer (rg, rg, la), bf16, its config's remat, ``train_step`` on
    one micro-batch of ``HYBRID_B`` x ``HYBRID_S`` — a warm-up step and
    one timed.  The training path is the plain one (the chunked RG-LRU
    scan, ``chunked_attention`` recomputed a query block at a time): no
    kernel launches."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.kernels import models as MK
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_state, train_step
    from repro_torch.tree import leaves
    t_all = time.perf_counter()
    cfg = dataclasses.replace(get_config(MODEL), n_layers=3,
                              tail_pattern=())
    if T.layer_kinds(cfg) != ["rg", "rg", "la"]:
        fail(f"train hybrid: layer kinds {T.layer_kinds(cfg)}")
    torch.cuda.empty_cache()
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(5), device=dev)
    n_params = sum(p.numel() for p in leaves(params))
    width = params["layers"][0]["mixer"]["w_x"].shape[-1]
    state = init_state(params)
    del params
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=2, total_steps=100)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab, HYBRID_S, HYBRID_B),
                             device=dev)
    print(f"train hybrid: {cfg.name} {cfg.dtype} at its published widths "
          f"(d={cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, window "
          f"{cfg.window}, RG-LRU width {width}), depth cut to "
          f"{T.layer_kinds(cfg)} (3 of 38 layers), remat "
          f"{cfg.remat_policy if cfg.remat else 'off'}: {n_params:,} "
          f"parameters; B={HYBRID_B} x S={HYBRID_S}")

    def step(st):
        return train_step(cfg, ocfg, 1, st, pipe.batch(int(st.data_step)))

    torch.cuda.synchronize()
    MK.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    (state, m), warm = _timed(lambda: step(state))
    (state, m), wall = _timed(lambda: step(state))
    peak = torch.cuda.max_memory_allocated()
    counts = dict(MK.launches)
    loss = float(m["loss"])
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((HYBRID_B, HYBRID_S, width), generator=g,
                    device=dev).to(torch.bfloat16)
    a = torch.rand((HYBRID_B, HYBRID_S, width), generator=g,
                   device=dev).to(torch.bfloat16)
    n_scan = scan_ops(x, a)
    del state, x, a
    torch.cuda.empty_cache()
    total = time.perf_counter() - t_all
    print(f"train hybrid: warm-up step {warm:.3f} s, step {wall:.3f} s "
          f"(loss {loss:.6f}), {HYBRID_B * HYBRID_S / wall:,.1f} tokens/s, "
          f"peak memory {peak:,} bytes; one RG-LRU scan call "
          f"[{HYBRID_B}, {HYBRID_S}, {width}] bf16 dispatches {n_scan} aten "
          f"operations; launches {json.dumps(counts)} (no kernel: the "
          f"plain training path); {total:.1f} s of wall (budget "
          f"{HYBRID_BUDGET_S} s)")
    if loss != loss or not bool(torch.isfinite(m["grad_norm"])):
        fail(f"train hybrid: loss {loss}, grad_norm {float(m['grad_norm'])}")
    if sum(counts.values()):
        fail(f"train hybrid: the training path launched kernels {counts}; "
             f"it takes use_kernel=False")
    if n_scan > HYBRID_S // 4:
        fail(f"train hybrid: one RG-LRU scan call dispatched {n_scan} aten "
             f"operations at S={HYBRID_S}; the chunked scan takes at most "
             f"S/4")


def phase_train(dev, rows, measured=None) -> None:
    """Phase 12: training on one device — (a) the kernel guard; (b) card
    against CPU: loss and gradients of the ten smoke configs and of
    smollm-360m at full width with 2 layers, one AdamW update, the int8
    MoE wire; (c) ``Trainer``'s bitwise resume on the card; (d)
    smollm-360m whole in bf16 at S=4096 (``train_path``); (e)
    recurrentgemma-9b at full width, one superlayer, S=4096
    (``train_hybrid``).  No kernel is
    on this path (the reference's ``loss_fn`` takes ``use_kernel=False``),
    so ``rows`` is not touched."""
    import torch
    t0 = time.perf_counter()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False    # fp32 stays fp32
    try:
        train_guard(dev)
        train_exact(dev)
        t1 = time.perf_counter()
        train_resume(dev)
        print(f"train resume {time.perf_counter() - t1:.1f} s")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    t1 = time.perf_counter()
    train_path(dev, measured)
    print(f"train path {time.perf_counter() - t1:.1f} s")
    train_hybrid(dev)
    print(f"training phase {time.perf_counter() - t0:.1f} s (budget "
          f"{TRAIN_BUDGET_S} s for the {TRAIN_STEPS} timed steps)")


def _timed(fn):
    """(``fn()``, its wall s to a device synchronisation)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_leaves(label: str, want, got) -> int:
    """Fail unless every leaf of ``got`` (DTensors or tensors) equals the
    leaf of ``want`` bit for bit, dtype and all; the number of leaves."""
    import torch
    from repro_torch.launch.sharding import full
    from repro_torch.tree import leaves_with_path
    pairs = list(zip(leaves_with_path(want), leaves_with_path(got)))
    for (path, a), (_, b) in pairs:
        b = full(b)
        if a.dtype != b.dtype or a.shape != b.shape or \
                not torch.equal(bits(a), bits(b)):
            fail(f"{label}: leaf {'/'.join(map(str, path))} differs")
    return len(pairs)


def mesh_train(dev, meshes) -> None:
    """smollm-360m whole in bf16: ``MESH_STEPS`` steps of ``train_step``,
    then of ``make_train_step`` in each mode from the same state, loss,
    grad norm and every leaf bit for bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticPipeline
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimConfig
    from repro_torch.train import init_state, make_train_step, train_step
    cfg = get_config(MESH_ARCH)
    torch.cuda.empty_cache()
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    ocfg = OptimConfig(peak_lr=3e-4, warmup_steps=1, total_steps=100)
    pipe = SyntheticPipeline(DataConfig(cfg.vocab, MESH_S, MESH_B),
                             device=dev)
    batches = [pipe.batch(i) for i in range(MESH_STEPS)]
    want, metrics, times = init_state(params), [], []
    for b in batches:
        (want, m), t = _timed(lambda: train_step(cfg, ocfg, 1, want, b))
        metrics.append(m)
        times.append(t)
    print(f"mesh train: {cfg.name} {cfg.dtype} whole ({cfg.n_layers} "
          f"layers, d={cfg.d_model}), B={MESH_B} S={MESH_S}: train_step "
          f"{', '.join(f'{t:.3f}' for t in times)} s; losses "
          f"{', '.join(f'{float(m['loss']):.6f}' for m in metrics)}")
    for mode, mesh in meshes:
        step = make_train_step(cfg, ocfg, mesh, params, 1,
                               sharding_mode=mode)
        got, ts = init_state(params), []
        for b, m in zip(batches, metrics):
            (got, m2), t = _timed(lambda: step(got, b))
            ts.append(t)
            for k in ("loss", "lr", "grad_norm"):
                if not torch.equal(bits(m[k]), bits(m2[k])):
                    fail(f"mesh train {mode}: {k} {float(m2[k])} against "
                         f"the unsharded {float(m[k])}")
        n = _same_leaves(f"mesh train {mode}", want, got)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        print(f"mesh train {mode} on {shape}: "
              f"make_train_step {', '.join(f'{t:.3f}' for t in ts)} s "
              f"against train_step {', '.join(f'{t:.3f}' for t in times)} s; "
              f"loss, lr, grad norm and all {n} leaves bit for bit")
        del got, step


def mesh_serve(dev, mesh) -> None:
    """smollm-360m whole in bf16: ``MESH_TOKENS`` greedy tokens through
    ``make_serve_step`` and through ``decode_step``, logits bit for
    bit."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import make_serve_step
    cfg = get_config(MESH_ARCH)
    torch.cuda.empty_cache()
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    s1 = T.init_decode_state(cfg, MESH_B, MESH_TOKENS + 1, dev)
    s2 = T.init_decode_state(cfg, MESH_B, MESH_TOKENS + 1, dev)
    step = make_serve_step(cfg, mesh, s2, params, global_batch=MESH_B)
    tok = torch.arange(MESH_B, dtype=torch.int32, device=dev)
    t_plain = t_mesh = 0.0
    with torch.no_grad():
        for i in range(MESH_TOKENS):
            (l1, s1), t = _timed(lambda: T.decode_step(params, cfg, tok, i,
                                                       s1))
            t_plain += t
            (l2, s2), t = _timed(lambda: step(params, tok, i, s2))
            t_mesh += t
            if not torch.equal(bits(l1), bits(l2.full_tensor())):
                fail(f"mesh serve: the logits of token {i} differ")
            tok = l1.argmax(-1).to(torch.int32)
    print(f"mesh serve: {cfg.name} {cfg.dtype} whole, B={MESH_B}, "
          f"{MESH_TOKENS} "
          f"greedy tokens: make_serve_step logits == decode_step's bit for "
          f"bit; {t_mesh / MESH_TOKENS * 1e3:.3f} ms a token sharded "
          f"(the weights' and caches' shards, no gather) against "
          f"{t_plain / MESH_TOKENS * 1e3:.3f} ms")


def mesh_filtered(dev, mesh, rows) -> None:
    """``filtered_batch`` over the mesh's ``data`` axis (one shard)
    against ``pushdown_select`` on the card, bit for bit, with
    ``select_scan`` launched once a call in the counted window."""
    import torch
    from repro_torch.core import pushdown as PD
    from repro_torch.data.pipeline import filtered_batch
    from repro_torch.kernels import nmp as NK
    n, w = MESH_ROWS, SEL_W
    g = torch.Generator(device=dev).manual_seed(57)
    table = torch.randn((n, w), generator=g, device=dev)
    match = torch.rand(n, generator=g, device=dev) < MESH_SEL
    table[:, 0] = torch.where(match, 1.0, -1.0)
    table[:, 1] = torch.where(match, 0.0, 2.0)
    torch.cuda.synchronize()
    NK.reset_launches()
    got, t = _timed(lambda: filtered_batch(mesh, "data", table, 0.0, 1.0,
                                           n))
    for _ in range(2):
        got, t2 = _timed(lambda: filtered_batch(mesh, "data", table, 0.0,
                                                1.0, n))
        t = min(t, t2)
    counts = dict(NK.launches)
    if counts != {"select_scan": 3, "regex_dfa": 0, "hash_probe": 0}:
        fail(f"mesh filtered_batch: launches {counts}, expected select_scan "
             f"once a call")
    rows["select_scan"]["launches"] += counts["select_scan"]
    want, tw = _timed(lambda: PD.pushdown_select([dev], n, table, 0.0, 1.0))
    same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
    if not same or int(got.moved_rows) != int(match.sum()):
        fail("mesh filtered_batch: differs from pushdown_select")
    print(f"mesh filtered_batch: {n} rows x {w} fp32 at {MESH_SEL}, "
          f"{int(got.moved_rows)} matches == pushdown_select bit for bit; "
          f"{t * 1e3:.3f} ms (best of 3) against {tw * 1e3:.3f} ms; "
          f"select_scan launched {counts['select_scan']} times in 3 calls")


def mesh_collectives(dev, mesh) -> None:
    """``compressed_psum`` and ``pipeline_apply`` on a group of one
    against their closed forms, bit for bit."""
    import torch
    from repro_torch.optim import compression
    from repro_torch.runtime import pipeline_apply
    g = {"w": torch.randn((960, 2560), generator=torch.Generator(
        device=dev).manual_seed(59), device=dev)}
    err = compression.init_error(g)
    mean, new_err = compression.compressed_psum(g, err, "data", mesh)
    q, sc, want_err = compression.compress_tree(g, err)
    if not (torch.equal(mean["w"], compression.dequantize(q["w"], sc["w"]))
            and torch.equal(new_err["w"], want_err["w"])):
        fail("mesh compressed_psum: differs from the dequantized codes")
    xm = torch.arange(24, dtype=torch.float32, device=dev).reshape(6, 4)
    out = pipeline_apply(mesh, "model", lambda p, x: x * p[0] + 1.0,
                         torch.full((1, 2), 3.0, device=dev), xm)
    if not torch.equal(out, xm * 3.0 + 1.0):
        fail("mesh pipeline_apply: differs from the serial stage")
    print("mesh collectives: compressed_psum (a [960, 2560] gradient) and "
          "pipeline_apply (one stage, 6 micro-batches) on a group of one "
          "equal their closed forms bit for bit")


def mesh_resume(dev, mesh) -> None:
    """A ``MESH_RESUME_LAYERS``-layer full-width ``TrainState`` after one
    step, checkpointed and resumed onto ``mesh``, bit for bit."""
    import dataclasses
    import shutil
    import tempfile

    import torch
    from repro_torch import convert
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime import resume_on_mesh
    from repro_torch.train import init_state, train_step
    cfg = dataclasses.replace(get_config(MESH_ARCH),
                              n_layers=MESH_RESUME_LAYERS)
    params = T.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 256), generator=torch.Generator(
        device=dev).manual_seed(4), device=dev, dtype=torch.int32)
    state, _ = train_step(cfg, OptimConfig(), 1, init_state(params),
                          {"tokens": toks, "targets": toks})
    root = tempfile.mkdtemp(prefix="mesh_resume_",
                            dir=os.path.join(HERE, "build"))
    try:
        path = ckpt.save(ckpt.step_path(root, 1),
                         convert.stack_train_state(state, cfg),
                         meta={"step": 1, "arch": cfg.name})
        (back, meta), t = _timed(lambda: resume_on_mesh(path, state, mesh,
                                                        cfg))
        n = _same_leaves("mesh resume", state, back)
        print(f"mesh resume: a {MESH_RESUME_LAYERS}-layer {cfg.name} "
              f"TrainState ({n} leaves, {os.path.getsize(path):,} bytes) "
              f"resumed onto {dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"in {t:.3f} s, every leaf bit for bit; meta "
              f"{json.dumps(meta)}")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def mesh_drivers() -> None:
    """``python -m repro_torch.launch.train`` and ``launch.serve`` on the
    smoke config, as subprocesses (run together), each to exit 0."""
    import shutil
    import tempfile
    root = tempfile.mkdtemp(prefix="mesh_drivers_",
                            dir=os.path.join(HERE, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))
    cmds = {"train": ["--arch", MESH_ARCH, "--smoke", "--steps", "4",
                      "--ckpt-every", "2", "--ckpt-dir",
                      os.path.join(root, "ck")],
            "serve": ["--arch", MESH_ARCH, "--smoke"]}
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.launch.{k}", *a], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, a in cmds.items()}
    try:
        outs = {k: p.communicate(timeout=300) for k, p in procs.items()}
    finally:
        for p in procs.values():
            p.kill()
        shutil.rmtree(root, ignore_errors=True)
    for k, p in procs.items():
        if p.returncode != 0:
            fail(f"mesh drivers: launch.{k} exited {p.returncode}: "
                 f"{outs[k][1][-2000:]}")
        print(f"mesh drivers: python -m repro_torch.launch.{k} "
              f"{' '.join(cmds[k][:3])}: exit 0; "
              f"{' '.join(outs[k][0].split())[-240:]}")
    print(f"mesh drivers: {time.perf_counter() - t0:.1f} s together")


def phase_mesh(dev, rows) -> None:
    """Phase 13: meshes on a one-device NCCL world (``mesh_train``,
    ``mesh_serve``, ``mesh_filtered``, ``mesh_collectives``,
    ``mesh_resume``, ``mesh_drivers``); the group is destroyed at the
    end, whatever happened."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import close, make_local_mesh, make_mesh
    t0 = time.perf_counter()
    mesh2 = make_local_mesh(("data", "model"), device=dev)
    try:
        mesh3 = make_mesh((1, 1, 1), ("pod", "data", "model"), dev)
        backend = str(dist.get_backend())
        if backend != "nccl":
            fail(f"mesh: the process group speaks {backend}, not nccl")
        print(f"mesh: a one-device world over {backend}: "
              f"{dict(zip(mesh2.mesh_dim_names, mesh2.shape))} and "
              f"{dict(zip(mesh3.mesh_dim_names, mesh3.shape))}")
        for label, fn in (
                ("train", lambda: mesh_train(dev, (("2d", mesh2),
                                                   ("fsdp", mesh3)))),
                ("serve", lambda: mesh_serve(dev, mesh3)),
                ("filtered_batch", lambda: mesh_filtered(dev, mesh2, rows)),
                ("collectives", lambda: mesh_collectives(dev, mesh2)),
                ("resume", lambda: mesh_resume(dev, mesh3))):
            t1 = time.perf_counter()
            fn()
            torch.cuda.empty_cache()
            print(f"mesh {label} {time.perf_counter() - t1:.1f} s")
    finally:
        close()
    if dist.is_initialized():
        fail("mesh: a process group outlived the phase")
    t1 = time.perf_counter()
    mesh_drivers()
    print(f"mesh drivers {time.perf_counter() - t1:.1f} s")
    print(f"mesh phase {time.perf_counter() - t0:.1f} s (budget "
          f"{MESH_BUDGET_S} s)")


def roofline_table() -> int:
    """The analytic roofline at the H100's rates of every (arch x shape x
    mesh) record, single pod and multi-pod, one line per (arch, shape);
    returns the number of records."""
    from repro_torch.configs import ARCHS, SHAPES, cell_applicable
    from repro_torch.roofline.analysis import analytic_roofline
    from repro_torch.roofline.analytic import MeshDesc
    meshes = (("single", MeshDesc(16, 16)), ("multi", MeshDesc(16, 16, 2)))
    n = 0
    print("roofline (analytic; NVIDIA H100 SXM data sheet: 989 TFLOP/s "
          "bf16, 3.35 TB/s HBM, 50 GB/s a device between nodes): arch, "
          "shape, then per mesh bottleneck, t_compute / t_memory / "
          "t_collective in ms, roofline fraction")
    for arch in sorted(ARCHS):
        cfg = ARCHS[arch]
        for cell in SHAPES:
            cols = []
            for name, md in meshes:
                n += 1
                if cell_applicable(cfg, cell):
                    cols.append(f"{name} skipped")
                    continue
                r = analytic_roofline(cfg, cell, md)
                for k in ("t_compute", "t_memory", "t_collective",
                          "roofline_fraction"):
                    if not r[k] >= 0 or r[k] == float("inf"):
                        fail(f"roofline: {arch} {cell.name} {name} {k} "
                             f"{r[k]}")
                cols.append(f"{name} {r['bottleneck'][:4]} "
                            f"{r['t_compute'] * 1e3:.4g}/"
                            f"{r['t_memory'] * 1e3:.4g}/"
                            f"{r['t_collective'] * 1e3:.4g} "
                            f"{r['roofline_fraction']:.3f}")
            print(f"roofline {arch:<20} {cell.name:<11} " + " | ".join(cols))
    return n


def roofline_measured(measured) -> None:
    """The analytic bound on one device beside this run's own steps:
    phase 12's smollm-360m train step and phase 3's recurrentgemma-9b
    prefill, at their shapes as ``ShapeCell``s on ``MeshDesc(1, 1)``."""
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.roofline.analysis import analytic_roofline
    from repro_torch.roofline.analytic import MeshDesc
    for label, arch, cell, key in (
            ("phase 12 train step", TRAIN_ARCH,
             ShapeCell("train_4k", TRAIN_S, TRAIN_BATCH, "train"),
             "train_step_s"),
            ("phase 3 prefill", MODEL,
             ShapeCell("prefill_32k", PREFILL_S, PREFILL_B, "prefill"),
             "prefill_s")):
        r = analytic_roofline(get_config(arch), cell, MeshDesc(1, 1))
        bound = max(r["t_compute"], r["t_memory"])
        got = measured.get(key)
        seen = "not measured (its phase did not run)" if got is None else (
            f"measured {got * 1e3:.3f} ms, the bound {100 * bound / got:.1f}% "
            f"of it")
        print(f"roofline vs measured: {label}, {arch} B={cell.global_batch} "
              f"S={cell.seq_len} on MeshDesc(1, 1): t_compute "
              f"{r['t_compute'] * 1e3:.3f} ms ({r['flops_global']:.4g} "
              f"flops), t_memory {r['t_memory'] * 1e3:.3f} ms "
              f"({r['mem_bytes_dev']:.4g} bytes), bottleneck "
              f"{r['bottleneck']}; {seen}")


def dryrun_start():
    """Start ``python -m repro_torch.launch.dryrun`` on one production
    cell, with no CUDA device visible (the dry run touches none), its
    output to files; (process, directory, start time, a thread that
    waits for the process and keeps its end time in ``ended``)."""
    import tempfile
    import threading
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="dryrun_", dir=os.path.join(HERE, "build"))
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               CUDA_VISIBLE_DEVICES="")
    with open(os.path.join(root, "log"), "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             DRYRUN_ARCH, "--shape", DRYRUN_SHAPE, "--mesh", DRYRUN_MESH,
             "--out", root], env=env, stdout=log, stderr=subprocess.STDOUT)
    t0 = time.perf_counter()

    def wait():
        proc.wait()
        waiter.ended = time.perf_counter()

    waiter = threading.Thread(target=wait, daemon=True)
    waiter.start()
    return proc, root, t0, waiter


def dryrun_finish(started) -> None:
    """Wait for the dry run, print its record; the record must be ``ok``
    on 256 chips with finite counted numbers."""
    import shutil
    proc, root, t0, waiter = started
    try:
        waiter.join(timeout=600)
        if waiter.is_alive():
            fail("dry run: no end within 600 s")
        code, wall = proc.returncode, waiter.ended - t0
        with open(os.path.join(root, "log")) as f:
            log = f.read()
        cid = f"{DRYRUN_ARCH}__{DRYRUN_SHAPE}__{DRYRUN_MESH}"
        path = os.path.join(root, cid + ".json")
        if code != 0 or not os.path.exists(path):
            fail(f"dry run: exit {code}: {log[-2000:]}")
        with open(path) as f:
            rec = json.load(f)
    finally:
        proc.kill()
        shutil.rmtree(root, ignore_errors=True)
    r, a = rec.get("roofline", {}), rec.get("roofline_analytic", {})
    if rec["status"] != "ok" or r.get("chips") != 256:
        fail(f"dry run {cid}: {rec['status']} {rec.get('error', '')}")
    for k in ("flops_per_device", "bytes_per_device",
              "coll_bytes_per_device", "t_compute", "t_memory",
              "t_collective"):
        if not 0 < r[k] < float("inf"):
            fail(f"dry run {cid}: {k} {r[k]}")
    mem = rec["memory_analysis"]
    print(f"dry run {cid} on a fake world of {r['chips']} ranks: "
          f"{rec['status']}, built in {rec['t_build_s']:.3f} s, traced in "
          f"{rec['t_trace_s']:.3f} s, {wall:.1f} s wall (budget "
          f"{DRYRUN_BUDGET_S} s), no CUDA device visible; rank 0 counted "
          f"{r['flops_per_device']:.4g} flops (analytic "
          f"{a['flops_global'] / a['chips']:.4g} a device, "
          f"{r['flops_per_device'] * a['chips'] / a['flops_global']:.3f}x), "
          f"{r['bytes_per_device']:.4g} bytes accessed, collectives "
          f"{r['coll_bytes_per_device']:,.0f} bytes a device (analytic "
          f"{a['coll_bytes_dev']:,.0f}): "
          f"{json.dumps({k: v for k, v in r['coll_breakdown'].items() if v})}"
          f" bytes in {json.dumps(rec['n_collectives'])} calls, peak "
          f"{mem['peak_size_in_bytes']:,} bytes (arguments "
          f"{mem['argument_size_in_bytes']:,}); counted: bottleneck "
          f"{r['bottleneck']}, useful flops {r['useful_flops_fraction']:.4f};"
          f" analytic: bottleneck {a['bottleneck']}, useful flops "
          f"{a['useful_flops_fraction']:.4f}, t_memory "
          f"{a['t_memory'] * 1e3:.4f} ms")
    if wall > DRYRUN_BUDGET_S:
        print(f"dry run: {wall:.1f} s, over its {DRYRUN_BUDGET_S} s budget")


def phase_roofline(measured, started=None) -> None:
    """Phase 14: the roofline — the analytic table of every record, the
    bound beside this run's measured steps, and one production dry-run
    cell (``started`` by ``dryrun_start``, else started here)."""
    t0 = time.perf_counter()
    if started is None:
        started = dryrun_start()
    n = roofline_table()
    if n != 80:
        fail(f"roofline: {n} records, expected 80")
    roofline_measured(measured)
    dryrun_finish(started)
    print(f"roofline phase {time.perf_counter() - t0:.1f} s (the dry run "
          f"overlapped phases 12 and 13; budget {DRYRUN_BUDGET_S} s)")


def check_no_host_sync(eng, ops: int, width: int, label: str,
                       **stream) -> None:
    """The step loop makes no host synchronisation: the synchronising
    calls counted by CUDA's sync debug mode do not grow with the step
    count.  ``stream`` are further ``StreamConfig`` fields (arrivals,
    admission, observe)."""
    import torch
    from repro_torch.traffic import StreamConfig, WorkloadSpec, run_stream
    syncs = []
    for n in (2, 8, 24):        # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_stream(eng, StreamConfig(
                    workload=WorkloadSpec("zipfian", ops=ops, seed=0),
                    width=width, steps=n, collect_trace=True, **stream))
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    if syncs[2] == 0:
        fail("CUDA's sync debug mode reported no synchronisation at all")
    if syncs[1] != syncs[2]:
        fail(f"{label}: the step loop synchronises with the host: "
             f"{syncs[1]} syncs in 8 steps, {syncs[2]} in 24")
    print(f"{label}: {syncs[2]} host syncs per run outside the step loop, "
          f"none inside (runs of 8 and 24 steps)")


#: the hand-written kernels of the coherency step, by a part of their
#: names in the profiler's trace (the last two run on the packed path
#: only).
STEP_KERNELS = ("credit_rank", "arb_winner", "count_fold", "lat_hist",
                "packed_any", "packed_fanout")


def fleet_members(homes: bool = False, ops: int = FLEET_OPS,
                  trace: bool = True):
    """Phase 9's fleets: the R x W grid (``FLEET_GRID``) or the homes
    sweep (``FLEET_HOMES`` at R=64), at the main path's L and B."""
    from repro_torch.traffic import (EngineConfig, StreamConfig,
                                     WorkloadSpec)
    wl = WorkloadSpec("zipfian", ops=ops, seed=0)
    if homes:
        return tuple((EngineConfig(remotes=R, lines=L, block=B, homes=h,
                                   home_bw=FLEET_HOME_BW,
                                   credits=FLEET_CREDITS),
                      StreamConfig(workload=wl, collect_trace=trace))
                     for h in FLEET_HOMES)
    return tuple((EngineConfig(remotes=r, lines=L, block=B),
                  StreamConfig(workload=wl, width=w, collect_trace=trace))
                 for r, w in FLEET_GRID)


def step_profile(dev, lo: int = 8, hi: int = 24, packed: bool = False,
                 mode: str = "") -> None:
    """Device operations and device time of one step from the profiler:
    the dense step (R=64, L=4096, B=32, W=1) or, with ``packed``, the
    packed two-home step (H=2, ``PACKED_OPS`` ops per remote); ``mode``
    "admission" runs the dense step under the admission loop (every op
    arrived at step 0, ``ADMISSION``'s cap), "observed" under the
    observability plane (``ObserveConfig(capacity=OBS_CAPACITY)``),
    "grid" and "homes" one step of phase 9's grid and homes fleets
    (``run_fleet``, every member on one leading axis); the
    difference between runs of ``hi`` and ``lo`` steps over ``hi - lo``,
    so a run's set-up and read-out cancel, with the entries and device
    time of each step kernel and the host's wall time per step (best of
    three runs of each length).  Uses only ``run_stream``'s public API,
    so the same code counts any tree of the port: import ``chip_smoke``,
    set ``sys.path[0]`` to that tree's ``src``, then call this."""
    import torch
    from repro_torch.traffic import (AdmissionConfig, ArrivalSpec,
                                     EngineConfig, FleetConfig,
                                     ObserveConfig, StreamConfig,
                                     WorkloadSpec, run_fleet, run_stream)
    extra = dict(homes=HOMES, packed=True) if packed else {}
    eng = EngineConfig(remotes=R, lines=L, block=B, **extra).build(dev)
    ops = PACKED_OPS if packed else WorkloadSpec().ops
    stream = {"": {},
              "admission": dict(arrivals=ArrivalSpec("at_step0"),
                                admission=AdmissionConfig(*ADMISSION)),
              "observed": dict(observe=ObserveConfig(
                  capacity=OBS_CAPACITY)),
              "grid": {}, "homes": {}}[mode]

    def run(n):
        if mode in ("grid", "homes"):
            members = fleet_members(mode == "homes", trace=False)
            return lambda: run_fleet(FleetConfig(members=members, steps=n),
                                     device=dev)
        return lambda: run_stream(eng, StreamConfig(
            workload=WorkloadSpec("zipfian", ops=ops, seed=0), width=1,
            steps=n, **stream))

    def wall(n):
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(n)()
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best

    # the loop stops once the run is quiet: divide by the steps it ran.
    ran = [engine_steps(run(n))[1] for n in (lo, hi)]
    if ran[1] <= ran[0]:
        fail(f"step profile {mode or 'dense'}: runs of {lo} and {hi} steps "
             f"ran {ran[0]} and {ran[1]}: the run is quiet before step {hi}")
    tallies, kernels = [], []
    for n in (lo, hi):
        on_card = device_entries(run(n), iters=1)
        per = {k: [ev for ev in on_card if k in ev.key]
               for k in STEP_KERNELS}
        kernels.append({k: (sum(ev.count for ev in evs),
                            sum(ev.self_device_time_total for ev in evs))
                        for k, evs in per.items()})
        tallies.append((sum(ev.count for ev in on_card),
                        sum(ev.self_device_time_total for ev in on_card),
                        sum(c for c, _ in kernels[-1].values()),
                        sum(t for _, t in kernels[-1].values())))
    n = ran[1] - ran[0]
    d = [(b - a) / n for a, b in zip(*tallies)]
    each = {k: ((kernels[1][k][0] - kernels[0][k][0]) / n,
                (kernels[1][k][1] - kernels[0][k][1]) / n)
            for k in STEP_KERNELS}
    ms = (wall(hi) - wall(lo)) / n * 1e3
    if mode in ("grid", "homes"):
        what = (f"H={FLEET_HOMES} at R={R} W=1" if mode == "homes" else
                f"(R, W)={FLEET_GRID}")
        label = (f"{mode} fleet step (M={len(fleet_members(mode == 'homes'))}"
                 f" members, {what}, L={L} B={B}")
    elif packed:
        label = f"packed two-home step (R={R} L={L} B={B} H={HOMES} W=1"
    else:
        label = f"{mode or 'dense'} step (R={R} L={L} B={B} W=1"
    print(f"{label}, runs of {ran[0]} and {ran[1]} steps): {d[0]:g} device "
          f"operations per step, device time {d[1]:.3f} us; the step "
          f"kernels {d[2]:g} entries, {d[3]:.3f} us; host wall "
          f"{ms:.3f} ms per step")
    print(f"{label.split(' (')[0]} kernels per step: " + "; ".join(
        f"{k} {c:g} entries {t:.3f} us" for k, (c, t) in each.items()))


def drive(dev, cfg_engine, width: int, ops: int, per_step, rows,
          label: str, steps: int = 0, validate: bool = True, **stream):
    """One run of ``ops`` per remote through ``run_stream`` (the default
    step budget unless ``steps``; ``stream`` are further ``StreamConfig``
    fields), with every launch count set to 0 just before it and read
    just after: launches exactly ``per_step`` times the steps run and,
    with ``validate``, oracle-validated with all ops retired.  Returns
    the run and its wall time in seconds."""
    import torch
    from repro_torch.kernels import coherency_step as K
    from repro_torch.traffic import (StreamConfig, WorkloadSpec, run_stream,
                                     summarize, validate_run)
    eng = cfg_engine.build(dev)
    cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=ops, seed=0),
                       width=width, steps=steps, collect_trace=validate,
                       **stream)
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    run, ran = engine_steps(lambda: run_stream(eng, cfg))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    s = summarize(run.counters, run.msg_count, run.payload_msgs)
    t1 = time.perf_counter()
    if validate:
        validate_run(run, moesi=cfg_engine.moesi, n_homes=cfg_engine.homes)
    t_val = time.perf_counter() - t1
    print(f"{label}: completed={run.completed} "
          f"ops_retired={s['ops_retired']} "
          f"ops_per_step={float(s['ops_per_step']):.6f} "
          f"steps={s['steps']} active_steps={s['active_steps']} "
          f"steps_run={ran} wall_s={wall:.3f} "
          f"steps_per_s={ran / wall:.1f} "
          f"msgs={int(run.msg_count.sum())} "
          f"oracle_validate_s={t_val:.1f}")
    print(f"{label}: launches {json.dumps(counts)}")
    for name, n in counts.items():
        if n != per_step[name] * ran:
            fail(f"{label}: kernel {name}: {n} launches, expected "
                 f"{per_step[name]} x {ran}")
        rows[name]["launches"] += n
    if validate and s["ops_retired"] != cfg_engine.remotes * ops:
        fail(f"{label}: retired {s['ops_retired']} of "
             f"{cfg_engine.remotes * ops}")
    return run, wall


def phase_main_path(dev, rows):
    """Phase 5: the closed-loop stream at R=64, L=4096, B=32."""
    from repro_torch.traffic import EngineConfig, default_steps
    print(f"main path: zipfian R={R} L={L} B={B} (fp32, "
          f"{4 * B}-byte lines) MOESI, W=1 at {W1_OPS} ops per remote "
          f"({default_steps(W1_OPS, R)} steps, the default budget), W=4 "
          f"at {W4_OPS} ({default_steps(W4_OPS, R)} steps)")
    cfg = EngineConfig(remotes=R, lines=L, block=B)
    step_profile(dev)
    check_no_host_sync(cfg.build(dev), W1_OPS, 4, "main path")
    for width, n_ops in ((1, W1_OPS), (4, W4_OPS)):
        drive(dev, cfg, width, n_ops, PER_STEP, rows,
              f"main path W={width}")
    for name in ("credit_rank", "arb_winner", "count_fold", "lat_hist"):
        if rows[name]["launches"] == 0:
            fail(f"kernel {name} was not launched on the main path")


def phase_packed_path(dev, rows):
    """Phase 7: the packed two-home path at R=64, L=4096, B=32."""
    from repro_torch.traffic import EngineConfig, WorkloadSpec, \
        default_steps
    ops = PACKED_OPS
    print(f"packed path: zipfian R={R} L={L} B={B} H={HOMES} packed "
          f"MOESI W=1, {ops} ops per remote (cut from "
          f"{WorkloadSpec().ops}), {default_steps(ops, R)} steps (default "
          f"budget)")
    cfg = EngineConfig(remotes=R, lines=L, block=B, homes=HOMES,
                       packed=True)
    dense, packed = (EngineConfig(remotes=R, lines=L, block=B,
                                  packed=p).build(dev).init()
                     for p in (False, True))
    nbytes = [x.hreq_pending.nbytes + x.dir.view.nbytes
              for x in (dense, packed)]
    print(f"packed path: directory state (view + pending mask) "
          f"{nbytes[0]} bytes dense (2*R*L) against {nbytes[1]} packed "
          f"(16*L*W), {nbytes[0] / nbytes[1]:g}x")
    if nbytes != [2 * R * L, 16 * L * NW]:
        fail(f"directory state bytes {nbytes}")
    step_profile(dev, packed=True)
    check_no_host_sync(cfg.build(dev), ops, 1, "packed path")
    drive(dev, cfg, 1, ops, PACKED_PER_STEP, rows, "packed path W=1")
    for name in ("packed_any", "packed_fanout"):
        if rows[name]["launches"] == 0:
            fail(f"kernel {name} was not launched on the packed path")


def _same_run(a, b) -> bool:
    """Counters, message counts, the trace, the open loop's histograms
    and backlog, and the observability digest equal."""
    import numpy as np
    import torch
    hists = all(
        (x is None and y is None) or np.array_equal(x, y)
        for x, y in ((a.sojourn_hist, b.sojourn_hist),
                     (a.admit_wait_hist, b.admit_wait_hist)))
    obs = (a.obs is None and b.obs is None) or (
        a.obs is not None and b.obs is not None
        and np.array_equal(a.obs.words, b.obs.words)
        and a.obs.metrics() == b.obs.metrics())
    return (np.array_equal(a.msg_count, b.msg_count)
            and a.payload_msgs == b.payload_msgs
            and np.array_equal(a.trace.retire_step, b.trace.retire_step)
            and all(torch.equal(x.cpu(), y.cpu())
                    for x, y in zip(a.counters, b.counters))
            and hists and a.backlog == b.backlog and obs)


def phase_small_stream(dev):
    """Phase 6: the card's kernel runs equal the CPU's plain runs, and
    each packed run equals the dense run of its configuration."""
    import torch
    from repro_torch.core.messages import MsgType
    from repro_torch.traffic import (AdmissionConfig, ArrivalSpec,
                                     EngineConfig, ObserveConfig,
                                     StreamConfig, WorkloadSpec, run_stream,
                                     validate_run)

    poisson = dict(arrivals=ArrivalSpec("poisson", rate=0.2, seed=1),
                   admission=AdmissionConfig(16, 2))
    # (ops per remote, engine options, stream options); the wide packed
    # streams take 4 ops (R=64 2) and the R=8 ones 8, since their step
    # budget grows with R * ops (and with the last arrival) and each runs
    # two or three times (card, CPU, and dense on the card); before phase
    # 13 the R=8 closed loops took 32 and the packed ones 8.
    cases = [
        (8, dict(remotes=8, moesi=False), {}),
        (8, dict(remotes=8, moesi=True), {}),
        (4, dict(remotes=33, homes=2, packed=True, moesi=False), {}),
        (2, dict(remotes=64, homes=2, packed=True, moesi=True), {}),
        (8, dict(remotes=8, homes=2, home_bw=1), {}),
        (8, dict(remotes=8, shared_credits=True, credits=4), {}),
        (8, dict(remotes=8), poisson),
        (8, dict(remotes=8), dict(arrivals=ArrivalSpec("bursty", rate=0.2,
                                                       seed=2))),
        (4, dict(remotes=33, homes=2, packed=True, moesi=False), poisson),
        (8, dict(remotes=8), dict(observe=ObserveConfig(
            specs=("req_resp", "single_writer", "readonly"),
            inject=(40, 3, int(MsgType.REQ_READ_SHARED))))),
    ]
    # the plain path's tensors are tiny: one intra-op thread keeps the
    # CPU's searchsorted and bucketize off a busy thread pool.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for ops, kw, skw in cases:
            t0 = time.perf_counter()
            cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=ops,
                                                     seed=3),
                               width=2, collect_trace=True, **skw)
            gpu, cpu = (run_stream(EngineConfig(lines=16, block=4, **kw)
                                   .build(d), cfg) for d in (dev, "cpu"))
            what = json.dumps({**kw, **{k: repr(v) for k, v in
                                        skw.items()}})
            if not _same_run(gpu, cpu):
                fail(f"small stream {what}: card and CPU differ")
            if kw.get("packed"):
                dense_kw = dict(kw, packed=False)
                dense = run_stream(EngineConfig(lines=16, block=4,
                                                **dense_kw).build(dev), cfg)
                if not _same_run(gpu, dense):
                    fail(f"small stream {what}: packed and dense runs "
                         f"differ")
            validate_run(gpu, moesi=kw.get("moesi", True),
                         n_homes=kw.get("homes", 1))
            extra = ""
            if gpu.sojourn_hist is not None:
                extra += (f", sojourn {gpu.sojourn_hist.tolist()}, "
                          f"backlog {gpu.backlog}")
            if gpu.obs is not None:
                extra += (f", {gpu.obs.captured_total} words, violations "
                          f"{[str(v) for v in gpu.obs.violations]}, "
                          f"phase_hist {gpu.obs.phase_hist.tolist()}")
            print(f"small stream {what} ops={ops}: card == CPU "
                  f"(counters, msg_count {int(gpu.msg_count.sum())}, "
                  f"payload {gpu.payload_msgs}, trace{extra})"
                  f"{', == dense' if kw.get('packed') else ''}, "
                  f"oracle-validated, {int(gpu.counters.steps)} steps, "
                  f"{time.perf_counter() - t0:.1f} s")
    finally:
        torch.set_num_threads(threads)


def open_window(tb):
    """(step, line) one step after a request parked two or more steps
    before its grant, from a captured trace: a second request on the
    line is illegal there."""
    from repro_torch.core import transport as tp
    from repro_torch.core.messages import MsgType
    reqs = (int(MsgType.REQ_READ_SHARED), int(MsgType.REQ_READ_EXCL),
            int(MsgType.REQ_UPGRADE))
    open_at = {}
    for m in tb.messages():
        klass = m.vc // 2
        if klass == tp.CLASS_REMOTE_REQ and m.msg_type in reqs:
            open_at[m.line] = m.txn
        elif klass == tp.CLASS_HOME_RESP and m.line in open_at:
            s = open_at.pop(m.line)
            if m.txn > s + 1:
                return s + 1, m.line
    fail("no open request window in the observed run's trace")


def phase_open_loop(dev, rows):
    """Phase 8: open loop and observation at the main path's width."""
    import numpy as np
    from repro_torch import convert
    from repro_torch.core.messages import MsgType
    from repro_torch.core.tracing import SPECS, check_trace
    from repro_torch.traffic import (AdmissionConfig, ArrivalSpec,
                                     EngineConfig, ObserveConfig,
                                     StreamConfig, WorkloadSpec, run_stream,
                                     sojourn_summary)
    t0 = time.perf_counter()
    cfg = EngineConfig(remotes=R, lines=L, block=B)
    adm = AdmissionConfig(*ADMISSION)
    print(f"open loop: zipfian R={R} L={L} B={B} MOESI dense W=1, "
          f"Poisson arrivals (seed 1) at {SOJ_RATE} ({OPEN_OPS} ops per "
          f"remote) and {OVERLOAD_RATE} ({OVERLOAD_OPS}) ops/step/remote, "
          f"admission "
          f"{ADMISSION}; observed against plain at {OBS_OPS} ops per "
          f"remote, ring of {OBS_CAPACITY} words")
    for mode in ("", "admission", "observed"):     # the dense step beside
        step_profile(dev, mode=mode)
    eng = cfg.build(dev)
    check_no_host_sync(eng, OPEN_OPS, 1, "open loop",
                       arrivals=ArrivalSpec("at_step0"), admission=adm)
    check_no_host_sync(eng, OBS_OPS, 1, "observed",
                       observe=ObserveConfig(capacity=OBS_CAPACITY))

    # ---- below the knee: completes, oracle-exact, no backlog -------------
    run, wall = drive(dev, cfg, 1, OPEN_OPS, PER_STEP, rows,
                      f"open loop rate {SOJ_RATE}",
                      arrivals=ArrivalSpec("poisson", rate=SOJ_RATE, seed=1),
                      admission=adm)
    s = sojourn_summary(run)
    steps = int(run.counters.steps)
    print(f"open loop rate {SOJ_RATE}: sojourn "
          f"p50={s['sojourn_percentiles']['p50']} "
          f"p99={s['sojourn_percentiles']['p99']} "
          f"p999={s['sojourn_percentiles']['p999']} admit_wait "
          f"p99={s['admit_wait_percentiles']['p99']} backlog={run.backlog} "
          f"steps={steps} wall_s={wall:.3f}")
    if not run.completed or run.backlog != 0:
        fail(f"open loop rate {SOJ_RATE}: completed={run.completed} "
             f"backlog={run.backlog}")

    # ---- past the knee: a fixed window of the arrival span --------------
    over = ArrivalSpec("poisson", rate=OVERLOAD_RATE, seed=1)
    last = int(over.materialize(OVERLOAD_OPS, R).step.max())
    run, wall = drive(dev, cfg, 1, OVERLOAD_OPS, PER_STEP, rows,
                      f"open loop rate {OVERLOAD_RATE}", steps=last,
                      validate=False, arrivals=over, admission=adm)
    s = sojourn_summary(run)
    print(f"open loop rate {OVERLOAD_RATE}: completed={run.completed} "
          f"backlog={run.backlog} sojourn p50="
          f"{s['sojourn_percentiles']['p50']} "
          f"p99={s['sojourn_percentiles']['p99']} admit_wait p99="
          f"{s['admit_wait_percentiles']['p99']} steps={last}")
    if run.completed or run.backlog <= 0:
        fail(f"open loop rate {OVERLOAD_RATE}: expected overload, got "
             f"completed={run.completed} backlog={run.backlog}")

    # ---- observed against plain ------------------------------------------
    wl = WorkloadSpec("zipfian", ops=OBS_OPS, seed=0)
    obs_cfg = ObserveConfig(capacity=OBS_CAPACITY)
    plain, seen = (run_stream(eng, StreamConfig(workload=wl, observe=o,
                                                collect_trace=True))
                   for o in (None, obs_cfg))
    a, b = (convert.flatten(convert.engine_state_to_numpy(x.state))
            for x in (plain, seen))
    same_state = a.keys() == b.keys() and all(
        np.array_equal(a[k], b[k]) for k in a)
    if not (same_state and _same_run(plain, seen._replace(obs=None))):
        fail("observed run differs from the plain run")
    if seen.obs.violations:
        fail(f"observed run: violations {seen.obs.violations}")
    tb = seen.obs.trace_buffer()
    host = {n: len(check_trace(SPECS[n], tb)) for n in obs_cfg.specs}
    print(f"observed: == plain (state, counters, msg_count, trace), "
          f"captured_total={seen.obs.captured_total} "
          f"dropped={seen.obs.dropped} "
          f"delivered={int(seen.msg_count.sum())} violations=0 "
          f"host check_trace {host} phase p99 "
          f"{ {k: v['p99'] for k, v in seen.obs.phase_percentiles().items()} }")
    if any(host.values()) or seen.obs.captured_total + seen.obs.dropped \
            != int(seen.msg_count.sum()):
        fail("observed: host check or word count disagrees")

    # ---- an injected violation, latched at its (step, line) -------------
    istep, iline = open_window(tb)
    bad = run_stream(eng, StreamConfig(
        workload=wl, steps=istep + 8, observe=obs_cfg._replace(
            inject=(istep, iline, int(MsgType.REQ_READ_SHARED)))))
    v = [v for v in bad.obs.violations if v.spec == "req_resp"]
    hv = check_trace(SPECS["req_resp"], bad.obs.trace_buffer())
    print(f"inject REQ_READ_SHARED at step {istep} line {iline}: online "
          f"{[str(x) for x in v]}; host check_trace "
          f"{[str(x) for x in hv[:1]]}")
    if not v or (v[0].step, v[0].line) != (istep, iline) or \
            not any(x.line == iline for x in hv):
        fail("the injected violation was not latched at its step and line")
    print(f"open loop and observation phase {time.perf_counter() - t0:.1f} s")


def check_fleet_no_host_sync(dev) -> None:
    """The member-batched loop makes no host synchronisation: the syncs
    CUDA's sync debug mode counts do not grow with the step count."""
    import torch
    from repro_torch.traffic import FleetConfig, run_fleet
    members = fleet_members(homes=True)
    syncs = []
    for n in (2, 8, 24):        # the first run builds the cached constants
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                run_fleet(FleetConfig(members=members, steps=n), device=dev)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs.append(sum("synchroniz" in str(w.message) for w in caught))
    if syncs[2] == 0:
        fail("CUDA's sync debug mode reported no synchronisation at all")
    if syncs[1] != syncs[2]:
        fail(f"fleet: the member-batched loop synchronises with the host: "
             f"{syncs[1]} syncs in 8 steps, {syncs[2]} in 24")
    print(f"fleet: {syncs[2]} host syncs per run outside the step loop, "
          f"none inside (runs of 8 and 24 steps)")


def drive_fleet(dev, homes: bool, rows, solo_at) -> None:
    """One fleet of phase 9 through ``run_fleet``, launch counts set to 0
    just before it and read just after (``PER_STEP`` per fleet step: the
    members share each launch); every member completes and replays into
    its oracle; the members at ``solo_at`` run solo through
    ``run_stream`` at the fleet's budget and must be bit-identical."""
    import torch
    from repro_torch.kernels import coherency_step as K
    from repro_torch.traffic import (FleetConfig, StreamConfig, fleet_steps,
                                     run_fleet, run_stream, summarize,
                                     validate_run)
    fleet = FleetConfig(members=fleet_members(homes))
    steps = fleet_steps(fleet)
    label = "homes fleet" if homes else "grid fleet"
    torch.cuda.synchronize()
    K.reset_launches()
    t0 = time.perf_counter()
    runs, ran = engine_steps(lambda: run_fleet(fleet, device=dev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(K.launches)
    print(f"{label}: launches {json.dumps(counts)} in {ran} of {steps} "
          f"steps (the loop stops once every member is quiet)")
    for name, n in counts.items():
        if n != PER_STEP[name] * ran:
            fail(f"{label}: kernel {name}: {n} launches, expected "
                 f"{PER_STEP[name]} x {ran} (one per fleet step)")
        rows[name]["launches"] += n
    M = len(runs)
    for (e, s), run in zip(fleet.members, runs):
        sm = summarize(run.counters, run.msg_count, run.payload_msgs)
        validate_run(run, moesi=e.moesi, n_homes=e.homes)
        if sm["ops_retired"] != e.remotes * s.workload.ops:
            fail(f"{label}: member R={e.remotes} W={s.width} H={e.homes} "
                 f"retired {sm['ops_retired']}")
        print(f"{label} member R={e.remotes} W={s.width} H={e.homes}: "
              f"completed={run.completed} ops_retired={sm['ops_retired']} "
              f"ops_per_step={float(sm['ops_per_step']):.6f} "
              f"max_wait={max(sm['max_wait'])} "
              f"msgs={int(run.msg_count.sum())} oracle-validated")
    solo_wall = 0.0
    for i in solo_at:
        e, s = fleet.members[i]
        eng = e.build(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo = run_stream(eng, StreamConfig(
            workload=s.workload, width=s.width, steps=steps,
            collect_trace=True))
        torch.cuda.synchronize()
        w = time.perf_counter() - t0
        solo_wall += w
        if not _same_run(runs[i], solo):
            fail(f"{label}: member {i} differs from its solo run")
        print(f"{label}: member {i} (R={e.remotes} W={s.width} "
              f"H={e.homes}) == its solo run_stream, solo wall_s={w:.3f}")
    print(f"{label}: M={M} members x {ran} steps in wall_s={wall:.3f}: "
          f"member_steps_per_s={M * ran / wall:.1f} fleet_steps_per_s="
          f"{ran / wall:.1f}; the {len(solo_at)} solo runs of the "
          f"{steps}-step budget wall_s={solo_wall:.3f}")


def phase_fleet(dev, rows):
    """Phase 9: fleets and the command line on the card."""
    import contextlib
    import io
    import torch
    from repro_torch.kernels import coherency_step as K
    from repro_torch.kernels import ref
    from repro_torch.traffic import (EngineConfig, FleetConfig, StreamConfig,
                                     WorkloadSpec, fleet_steps, run_fleet)
    from repro_torch.traffic import run as cli
    t0 = time.perf_counter()
    print(f"fleets: zipfian L={L} B={B} MOESI, {FLEET_OPS} ops per remote; "
          f"grid (R, W) in {FLEET_GRID}; homes H in {FLEET_HOMES} at R={R} "
          f"home_bw={FLEET_HOME_BW} credits={FLEET_CREDITS}")
    for mode in ("", "grid", "homes"):          # the dense step beside
        step_profile(dev, mode=mode)
    check_fleet_no_host_sync(dev)
    drive_fleet(dev, False, rows, solo_at=(0, 3))      # R=16 W=1, R=64 W=4
    drive_fleet(dev, True, rows, solo_at=(1, 2))       # H=2, H=4

    # ---- a small fleet, card against CPU -------------------------------
    small = FleetConfig(members=tuple(
        (EngineConfig(remotes=r, lines=16, block=4, homes=h, home_bw=bw),
         StreamConfig(workload=WorkloadSpec("zipfian", ops=8, seed=sd),
                      width=w, collect_trace=True))
        for r, w, h, bw, sd in ((2, 1, 1, 0, 1), (8, 2, 2, 1, 2),
                                (5, 3, 4, 0, 3))))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        card, cpu = (run_fleet(small, device=d) for d in (dev, "cpu"))
    finally:
        torch.set_num_threads(threads)
    if not all(_same_run(a, b) for a, b in zip(card, cpu)):
        fail("small fleet: card and CPU differ")
    print(f"small fleet (R<=8, L=16, {len(card)} members, "
          f"{fleet_steps(small)} steps): card == CPU")

    # ---- the grouped count_fold at a fleet's shape ------------------------
    M = len(FLEET_GRID)
    g = torch.Generator().manual_seed(9)
    mk = (torch.rand((M, R * L), generator=g) < 0.05).to(dev)
    pk = (torch.rand((M, R * L), generator=g) < 0.5).to(dev)
    ck = torch.randint(0, 16, (M, R * L), generator=g,
                       dtype=torch.int8).to(dev)
    bk = (torch.zeros((M, 16), dtype=torch.int32, device=dev),
          torch.zeros(M, dtype=torch.int32, device=dev))
    time_form(f"count_fold grouped [{M}, {R}, {L}] (one launch for the "
              f"fleet's members)", "count_fold",
              lambda: K.count_fold(mk, ck, pk, base=bk, grouped=True),
              lambda: ref.count_fold_ref(mk, ck, pk, base=bk, grouped=True),
              nbytes=3 * M * R * L + 2 * 4 * 17 * M, nops=4 * M * R * L)

    # ---- the command line on the card ---------------------------------
    if cli.smoke(device=dev.type) != 0:
        fail("python -m repro_torch.traffic.run --smoke: a case failed")
    art = os.path.join(HERE, "build", "cli_artifacts")
    argv = ["--device", dev.type, "--remotes", str(R), "--lines", str(L),
            "--ops", str(FLEET_OPS), "--validate"]
    outs = []
    for extra in (["--artifacts", art],
                  ["--config", os.path.join(art, "config.json")]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            cli.main(argv + extra)
        outs.append(json.loads(buf.getvalue()))
    print(f"cli: --remotes {R} --lines {L} --ops {FLEET_OPS} --validate: "
          f"completed={outs[0]['completed']} "
          f"ops_retired={outs[0]['ops_retired']} steps={outs[0]['steps']} "
          f"wall_s={outs[0]['wall_s']}; replayed through --config "
          f"wall_s={outs[1]['wall_s']}")
    for out in outs:
        out.pop("wall_s")
    if outs[0] != outs[1] or not outs[0]["completed"]:
        fail("cli: the --config replay printed another summary")
    print(f"fleets and command line phase {time.perf_counter() - t0:.1f} s")


def store_program(dev, subset: str, lines: int, block: int, seed: int):
    """Phase 10 (a)'s program through ``CoherentStore(n_remotes=1)`` on
    ``dev``: read every line, read them again (all hits); where the
    subset allows stores, write half the lines, evict a quarter (half of
    them dirty) and ``home_read`` the dirty lines left; otherwise evict a
    quarter; ``home_write`` the evicted (uncached) lines and read them;
    then, on a second store with an operator, read ``VIRTUAL_BLOCKS``
    virtual blocks, evict them and read them again, the operator run
    once.  Returns (the two stores, the values read)."""
    import numpy as np
    from repro_torch.core import SUBSETS, CoherentStore
    rng = np.random.default_rng(seed)
    backing = rng.standard_normal((lines, block)).astype(np.float32)
    cs = CoherentStore(backing, SUBSETS[subset], max_rounds=STORE_ROUNDS,
                       device=dev)
    every = np.arange(lines)
    quarter = every[::4]
    out = [cs.read(every), cs.read(every)]
    if SUBSETS[subset].check_workload([2]):
        cs.write(every[::2], rng.standard_normal(
            (lines // 2, block)).astype(np.float32))
        cs.evict(quarter)
        out.append(cs.home_read(every[2::4]))
    else:
        cs.evict(quarter)
    cs.home_write(quarter, rng.standard_normal(
        (len(quarter), block)).astype(np.float32))
    out.append(cs.read(quarter))
    calls = []

    def operator(blocks):
        calls.append(len(blocks))
        return blocks * 2.0 + 1.0

    vs = CoherentStore(backing, SUBSETS[subset], operator=operator,
                       max_rounds=STORE_ROUNDS, device=dev)
    virtual = every[:VIRTUAL_BLOCKS]
    out.append(vs.read(virtual))
    vs.evict(virtual)
    out.append(vs.read(virtual))
    if calls != [VIRTUAL_BLOCKS]:
        fail(f"store {subset}: the operator ran on {calls} blocks, "
             f"expected once on {VIRTUAL_BLOCKS}")
    return (cs, vs), out


def store_digest(stores, out):
    """What phase 10 holds card against CPU: every state leaf, every
    value read (as bits) and the accounting of each store."""
    from repro_torch.convert import flatten
    return ([flatten(cs.state) for cs in stores],
            [bits(v.cpu()).numpy() for v in out],
            [(cs.interconnect_messages, cs.hits, cs.misses,
              cs.payload_bytes) for cs in stores])


def same_digest(a, b) -> bool:
    import numpy as np
    return (all(x.keys() == y.keys() and all(np.array_equal(x[k], y[k])
                                             for k in x)
                for x, y in zip(a[0], b[0]))
            and all(np.array_equal(x, y) for x, y in zip(a[1], b[1]))
            and a[2] == b[2])


def two_node_profile(dev) -> None:
    """The rounds of one two-node ``Engine.run_ops`` (a LOAD of every
    line from the quiescent state, MOESI, L lines of B fp32) with the
    launches per step from the wrappers' counters and the host wall per
    round (best of three); and the device operations and device time of
    one step of that run (its ninth, channels busy) from the profiler."""
    import torch
    from repro_torch.core.engine import Engine
    from repro_torch.kernels import coherency_step as K
    eng = Engine(torch.zeros((L, B), device=dev), device=dev)
    st0 = eng.init()
    opv = torch.ones(L, dtype=torch.int8, device=dev)
    vv = torch.zeros((L, B), device=dev)
    K.reset_launches()
    rounds = eng.run_ops(st0, opv, vv, STORE_ROUNDS)[3]
    per_step = {k: n / rounds for k, n in K.launches.items() if n}
    best = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.run_ops(st0, opv, vv, STORE_ROUNDS)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    st, op = st0, opv
    for _ in range(8):
        st, out = eng.step(st, op, vv)
        op = op.masked_fill(out.accepted, 0)
    ms, ops = device_ms(lambda: eng.step(st, op, vv), 20)
    print(f"two-node run_ops (L={L} B={B} MOESI, a LOAD of every line): "
          f"{rounds} rounds, host wall {best / rounds * 1e3:.3f} ms per "
          f"round (a step and one host read of the busy flag); launches "
          f"per step {json.dumps(per_step)}; one step {ops:g} device "
          f"operations, {ms * 1e3:.3f} us of device time")


def store_fanout(dev, remotes: int, lines: int, block: int):
    """Phase 10 (b): every node of an N-remote FULL_MOESI store reads
    every line, then node 0 writes them all.  Returns (the store, the
    HOME_DOWNGRADE_I the write sent, the write's rounds)."""
    import numpy as np
    from repro_torch.core import FULL_MOESI, CoherentStore
    cs = CoherentStore(np.zeros((lines, block), np.float32), FULL_MOESI,
                       n_remotes=remotes, max_rounds=STORE_ROUNDS,
                       device=dev)
    ids = np.arange(lines)
    for node in range(remotes):
        cs.read(ids, node=node)
    before = cs.interconnect_messages.get("HOME_DOWNGRADE_I", 0)
    steps = int(cs.state.step_no)
    cs.write(ids, np.ones((lines, block), np.float32), node=0)
    return (cs, cs.interconnect_messages.get("HOME_DOWNGRADE_I", 0) - before,
            int(cs.state.step_no) - steps)


def count_store_launches(label: str, counts, steps: int, per_step,
                         rows) -> None:
    """Fail unless a store run launched ``per_step`` times its steps of
    every kernel; add the launches to the kernels' rows."""
    print(f"{label}: {steps} steps, launches {json.dumps(counts)}")
    for name, n in counts.items():
        if n != per_step[name] * steps:
            fail(f"{label}: kernel {name}: {n} launches, expected "
                 f"{per_step[name]} x {steps}")
        rows[name]["launches"] += n


def serve_tier(dev) -> None:
    """Phase 10 (c): recurrentgemma-9b at its published widths in bf16
    (parameters drawn on the card) behind ``CoherentPrefixTier`` with 1
    and 4 readers: a cold request (a miss in each tier, one prefill of
    the prompts, published to both tiers, decoded), a hot request in each
    tier (a lookup, decoded: the cold tokens exactly), every reader
    reading the line, then a republish that must invalidate each of them;
    then the weights quantized on the card (one leaf of each shape bit
    for bit against the CPU's) and the same requests decoded in int8."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serve import (CoherentPrefixTier, ServeEngine,
                                   quantize_params)
    from repro_torch.serve.quantize import is_quantized, quantize_weight
    cfg = get_config(MODEL)
    gen = torch.Generator(device=dev).manual_seed(65)
    t0 = time.perf_counter()
    params = T.init_params(cfg, generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab, (PREFILL_B, PROMPT),
                            generator=gen, device=dev)
    print(f"serve tier: {MODEL} parameters drawn on the card in "
          f"{time.perf_counter() - t0:.1f} s")
    prefix = tuple(int(t) for t in prompts.reshape(-1).cpu())
    engine = ServeEngine(cfg, params, max_seq=PROMPT + NEW_TOKENS,
                         device=dev)
    tiers = {n: CoherentPrefixTier(n_readers=n, device=dev)
             for n in TIER_READERS}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    (state, idx, lg), t_pre = timed(lambda: engine.prefill(prompts))
    for tier in tiers.values():
        if tier.lookup(prefix) is not None:
            fail("serve tier: a prefix hit before it was published")
        tier.publish(prefix, (state, idx, lg))
    (cold, _), t_cold = timed(lambda: engine.decode(state, lg.argmax(-1),
                                                    idx, NEW_TOKENS))
    if cold.shape != (PREFILL_B, NEW_TOKENS):
        fail(f"serve tier: cold tokens of shape {tuple(cold.shape)}")
    print(f"serve tier: {MODEL} {cfg.dtype}, {PREFILL_B} prompts of {PROMPT} "
          f"tokens: cold request prefill {t_pre:.3f} s "
          f"({PREFILL_B * PROMPT / t_pre:.1f} tokens/s through "
          f"decode_step), decode {NEW_TOKENS} tokens {t_cold:.3f} s "
          f"({PREFILL_B * NEW_TOKENS / t_cold:.1f} tokens/s)")
    for n, tier in tiers.items():
        def hot():
            s, i, last = tier.lookup(prefix, reader=n - 1)
            return engine.decode(s, last.argmax(-1), i, NEW_TOKENS)[0]
        toks, t_hot = timed(hot)
        if not torch.equal(toks, cold):
            fail(f"serve tier n_readers={n}: the hot request's tokens "
                 f"differ from the cold one's")
        for reader in range(n):
            tier.lookup(prefix, reader=reader)
        before = tier.store.interconnect_messages.get("HOME_DOWNGRADE_I", 0)
        tier.publish(prefix, (state, idx, lg))
        inv = tier.store.interconnect_messages.get("HOME_DOWNGRADE_I",
                                                   0) - before
        if inv != n:
            fail(f"serve tier n_readers={n}: the republish sent {inv} "
                 f"HOME_DOWNGRADE_I to {n} readers holding the line")
        print(f"serve tier n_readers={n}: hot request (lookup + decode) "
              f"{t_hot:.3f} s, tokens == cold; republish invalidated {inv} "
              f"of {n} readers; hit rate {tier.hit_rate:.3f}; traffic "
              f"{json.dumps(tier.store.interconnect_messages)}")

    qparams, t_q = timed(lambda: quantize_params(params, cfg=cfg))
    shapes = {}
    for layer, qlayer in zip(params["layers"], qparams["layers"]):
        for blk, qblk in zip(layer.values(), qlayer.values()):
            for k, w in blk.items():
                if is_quantized(qblk[k]):
                    shapes.setdefault(tuple(w.shape), (w, qblk[k]))
    for shape, (w, qw) in shapes.items():
        want = quantize_weight(w.cpu())
        if not (torch.equal(qw["q"].cpu(), want["q"]) and torch.equal(
                bits(qw["s"].cpu()), bits(want["s"]))):
            fail(f"quantize_weight {shape}: the card's q/s differ from "
                 f"the CPU's")

    def weight_bytes(tree):
        if isinstance(tree, dict):
            return sum(weight_bytes(v) for v in tree.values())
        if isinstance(tree, list):
            return sum(weight_bytes(v) for v in tree)
        return tree.numel() * tree.element_size()

    qengine = ServeEngine(cfg, qparams, max_seq=PROMPT + NEW_TOKENS,
                          device=dev)
    (qs, qi, qlg), t_qpre = timed(lambda: qengine.prefill(prompts))
    (qtoks, _), t_qdec = timed(lambda: qengine.decode(
        qs, qlg.argmax(-1), qi, NEW_TOKENS))
    agree = float((qtoks == cold).float().mean())
    n_q = sum(is_quantized(w) for layer in qparams["layers"]
              for blk in layer.values() for w in blk.values())
    print(f"serve int8: quantize_params on the card {t_q:.3f} s, {n_q} "
          f"weights, one of each shape {sorted(shapes)} bit-exact against "
          f"the CPU; weight bytes bf16 {weight_bytes(params)} int8 "
          f"{weight_bytes(qparams)}; prefill {t_qpre:.3f} s, decode "
          f"{PREFILL_B * NEW_TOKENS / t_qdec:.1f} tokens/s (bf16 "
          f"{PREFILL_B * NEW_TOKENS / t_cold:.1f}); token agreement with "
          f"bf16 {agree:.3f} (random weights: printed, not held)")
    del params, qparams, engine, qengine, state, qs, tiers
    torch.cuda.empty_cache()


def phase_store_serve(dev, rows):
    """Phase 10: the two-node store and the serving tier on the card."""
    import torch
    from repro_torch.core.multinode import MultiNodeRef
    from repro_torch.kernels import coherency_step as K
    t0 = time.perf_counter()
    print(f"store: CoherentStore(n_remotes=1) at L={L} B={B} fp32 for "
          f"{', '.join(STORE_SUBSETS)}, card against CPU")
    two_node_profile(dev)
    card = {}
    torch.cuda.synchronize()
    K.reset_launches()
    t1 = time.perf_counter()
    for subset in STORE_SUBSETS:
        card[subset] = store_program(dev, subset, L, B, seed=10)
    torch.cuda.synchronize()
    t_card = time.perf_counter() - t1
    steps = sum(int(cs.state.step_no) for stores, _ in card.values()
                for cs in stores)
    count_store_launches("store two-node path", dict(K.launches), steps,
                         TWO_NODE_PER_STEP, rows)
    t1 = time.perf_counter()
    for subset, (stores, out) in card.items():
        cpu = store_program("cpu", subset, L, B, seed=10)
        if not same_digest(store_digest(stores, out), store_digest(*cpu)):
            fail(f"store {subset}: card and CPU differ")
        cs = stores[0]
        if subset == "stateless" and (cs.state.dir.home_state.any()
                                      or cs.state.dir.view.any()):
            fail("store stateless: the home kept per-line state")
        print(f"store {subset}: card == CPU on {len(out)} reads, every "
              f"state leaf and the accounting; {int(cs.state.step_no)} "
              f"rounds; hits {cs.hits} misses {cs.misses}; payload bytes "
              f"{cs.payload_bytes}; {json.dumps(cs.interconnect_messages)}")
    print(f"store two-node path: card {t_card:.3f} s for the four "
          f"subsets' programs, {steps} rounds ({t_card / steps * 1e3:.3f} "
          f"ms a round); CPU {time.perf_counter() - t1:.3f} s; (a) "
          f"{time.perf_counter() - t0:.1f} s")

    torch.cuda.synchronize()
    K.reset_launches()
    t1 = time.perf_counter()
    cs, sent, rounds = store_fanout(dev, R, FANOUT_LINES, B)
    torch.cuda.synchronize()
    t_fan = time.perf_counter() - t1
    count_store_launches(f"store fan-out R={R}", dict(K.launches),
                         int(cs.state.step_no), STORE_MN_PER_STEP, rows)
    ref = MultiNodeRef(1, n_remotes=R)
    for node in range(R):
        ref.load(node, 0)
    rbefore = ref.invalidation_messages()
    ref.store(0, 0, 1)
    per_line = ref.invalidation_messages() - rbefore
    if sent != per_line * FANOUT_LINES or per_line != R - 1:
        fail(f"store fan-out R={R}: {sent} HOME_DOWNGRADE_I, expected "
             f"{per_line} x {FANOUT_LINES} (MultiNodeRef per line times "
             f"the lines)")
    print(f"store fan-out R={R} L={FANOUT_LINES} B={B}: every node reads "
          f"every line, node 0 writes them all: {sent} HOME_DOWNGRADE_I = "
          f"{per_line} x {FANOUT_LINES} (MultiNodeRef); the write took "
          f"{rounds} rounds of "
          f"max_rounds={STORE_ROUNDS}; {int(cs.state.step_no)} rounds in "
          f"{t_fan:.3f} s")
    del cs
    small = [store_fanout(d, *SMALL_FANOUT, B) for d in (dev, "cpu")]
    if not same_digest(store_digest([small[0][0]], []),
                       store_digest([small[1][0]], [])) or \
            small[0][1:] != small[1][1:]:
        fail(f"store fan-out R, L = {SMALL_FANOUT}: card and CPU differ")
    print(f"store fan-out R, L = {SMALL_FANOUT}: card == CPU, "
          f"{small[0][1]} HOME_DOWNGRADE_I in {small[0][2]} rounds; (b) "
          f"{time.perf_counter() - t1:.1f} s")

    t1 = time.perf_counter()
    serve_tier(dev)
    print(f"serve tier (c) {time.perf_counter() - t1:.1f} s")
    print(f"store and serving phase {time.perf_counter() - t0:.1f} s")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}")
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    sources = ("coherency_step", "nmp", "models")
    reports = {}
    with ThreadPoolExecutor(len(sources)) as pool:    # one nvcc per source
        libs = list(pool.map(lambda src: build.build(
            src, verbose=True, log=lambda text: reports.update({src: text})),
            sources))
    print(f"build: {', '.join(lib.name for lib in libs)} in parallel in "
          f"{time.perf_counter() - t0:.2f} s")
    for src, kernel in (("models", "flash_attention_tc_kernel"),
                        ("models", "rglru_scan_kernel"),
                        ("coherency_step", "lat_hist_kernel"),
                        ("coherency_step", "credit_rank_kernel"),
                        ("coherency_step", "count_fold_kernel"),
                        ("nmp", "regex_dfa_smem_kernel"),
                        ("nmp", "hash_probe_kernel")):
        for line in ptxas_summary(reports.get(src, ""), kernel):
            print(f"ptxas: {kernel} {line}")
    print(f"flash_attention_tc_kernel dynamic shared memory at D=256: "
          f"{TC_SMEM_D256} bytes (Q, two K and two V stages, alignment, "
          f"mbarriers)")

    rows = phase_kernels(dev)
    measured = {}        # seconds of the steps phase 14 sets its bounds by
    phase_model(dev, rows, measured)
    phase_nmp(dev, rows)
    phase_main_path(dev, rows)
    phase_small_stream(dev)
    phase_packed_path(dev, rows)
    phase_open_loop(dev, rows)
    phase_fleet(dev, rows)
    phase_store_serve(dev, rows)
    phase_families(dev, rows)
    started = dryrun_start()     # on the CPU, beside phases 12 and 13
    try:
        phase_train(dev, rows, measured)
        phase_mesh(dev, rows)
        phase_roofline(measured, started)
    finally:
        started[0].kill()
    print(f"total {time.perf_counter() - t_start:.1f} s")

    print(json.dumps({"kernels": list(rows.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
