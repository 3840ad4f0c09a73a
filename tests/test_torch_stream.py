"""The port's closed-loop ``run_stream`` against the reference.

* It reproduces the deterministic keys of ``benchmarks/BENCH_baseline.json``
  for the seven closed-loop ``streaming.*`` configs, fed the reference's
  ``[T, R]`` workload arrays, and passes its own oracle validation.
* On one small config per case it matches ``repro``'s ``run_stream``
  directly: counters, message counts and the retirement trace,
  bit-identical.

The committed baseline was generated with JAX's pre-0.5 random-bit
layout, so its workloads are drawn with ``jax.threefry_partitionable``
off; the arrays then equal the ones that produced the baseline.
"""
import json
import pathlib

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.traffic import (EngineConfig as JEngineConfig,  # noqa: E402
                           StreamConfig as JStreamConfig,
                           WorkloadSpec as JWorkloadSpec,
                           run_stream as j_run_stream,
                           summarize as j_summarize)
from repro_torch import convert  # noqa: E402
from repro_torch.traffic import (EngineConfig, StreamConfig,  # noqa: E402
                                 Workload, WorkloadSpec, default_steps,
                                 run_stream, summarize, validate_run)

BASELINE = json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks" / "BENCH_baseline.json").read_text())
KEYS = ("ops_per_step", "inval_per_excl_grant", "max_wait",
        "mean_mshr_occupancy", "ops_retired", "steps")
#: baseline key -> (workload, remotes, width); all at 16 lines, 32 ops.
CONFIGS = {
    "r2": ("zipfian", 2, 1),
    "r8": ("zipfian", 8, 1),
    "r32": ("zipfian", 32, 1),
    "r8_w2": ("zipfian", 8, 2),
    "producer_consumer_r8": ("producer_consumer", 8, 1),
    "migratory_r8": ("migratory", 8, 1),
    "false_sharing_r8": ("false_sharing", 8, 1),
}


def _reference_workload(name, R, L, ops, seed=0, legacy_bits=True):
    spec = JWorkloadSpec(name, ops=ops, seed=seed)
    if legacy_bits:
        with jax.threefry_partitionable(False):
            wl = spec.materialize(R, L)
    else:
        wl = spec.materialize(R, L)
    return Workload(*(np.array(x) for x in wl))


@pytest.mark.parametrize("key", list(CONFIGS))
def test_baseline_deterministic_keys(key):
    name, R, W = CONFIGS[key]
    ops, L = 32, 16
    steps = default_steps(ops, R)
    run = run_stream(EngineConfig(remotes=R, lines=L).build("cpu"),
                     StreamConfig(workload=_reference_workload(name, R, L,
                                                               ops),
                                  width=W, steps=steps, collect_trace=True))
    assert run.completed
    s = summarize(run.counters, run.msg_count, run.payload_msgs)
    got = {
        "ops_per_step": round(float(s["ops_per_step"]), 6),
        "inval_per_excl_grant": round(float(s["inval_per_excl_grant"]), 6),
        "max_wait": int(max(s["max_wait"])),
        "mean_mshr_occupancy": round(float(s["mean_mshr_occupancy"]), 3),
        "ops_retired": int(s["ops_retired"]),
        "steps": steps,
    }
    assert got == {k: BASELINE["streaming"][key][k] for k in KEYS}
    validate_run(run)


@pytest.mark.parametrize("width,moesi", [(2, True), (4, False)])
def test_stream_matches_reference_run(width, moesi):
    R, L, ops = 6, 16, 24
    wl = _reference_workload("zipfian", R, L, ops, seed=7,
                             legacy_bits=False)
    jrun = j_run_stream(
        JEngineConfig(remotes=R, lines=L, moesi=moesi).build(),
        JStreamConfig(workload=JWorkloadSpec("zipfian", ops=ops, seed=7),
                      width=width, collect_trace=True))
    trun = run_stream(EngineConfig(remotes=R, lines=L,
                                   moesi=moesi).build("cpu"),
                      StreamConfig(workload=wl, width=width,
                                   collect_trace=True))
    assert jrun.completed and trun.completed
    np.testing.assert_array_equal(trun.msg_count, jrun.msg_count)
    assert trun.payload_msgs == jrun.payload_msgs
    np.testing.assert_array_equal(trun.trace.retire_step,
                                  jrun.trace.retire_step)
    jctr = jax.tree_util.tree_map(np.asarray, jrun.counters)
    got = convert.counters_to_reference(trun.counters)
    for f in jctr._fields:
        np.testing.assert_array_equal(got[f], getattr(jctr, f), err_msg=f)
    # final engine states leaf by leaf, and the host digests agree.
    a = convert.flatten(jax.tree_util.tree_map(np.asarray, jrun.state))
    b = convert.flatten(trun.state)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    js = j_summarize(jrun.counters, jrun.msg_count, jrun.payload_msgs)
    ts = summarize(trun.counters, trun.msg_count, trun.payload_msgs)
    assert js == ts
    validate_run(trun, moesi=moesi)


@pytest.mark.parametrize("width", [1, 2, 4])
@pytest.mark.parametrize("name", ["zipfian", "false_sharing"])
def test_port_workloads_validate(name, width):
    """The port's own seeded generators through its own oracle."""
    run = run_stream(EngineConfig(remotes=4, lines=16).build("cpu"),
                     StreamConfig(workload=WorkloadSpec(name, ops=16,
                                                        seed=5),
                                  width=width, collect_trace=True))
    assert run.completed
    validate_run(run)
    assert int(run.counters.retired.sum()) == 4 * 16


def test_stream_rejects_out_of_subset_ops():
    eng = EngineConfig(remotes=2, lines=8, subset="read_only").build("cpu")
    with pytest.raises(ValueError, match="outside subset"):
        run_stream(eng, StreamConfig(workload=WorkloadSpec(
            "zipfian", ops=4)))


def test_stream_continues_from_state():
    eng = EngineConfig(remotes=3, lines=8).build("cpu")
    cfg = StreamConfig(workload=WorkloadSpec("zipfian", ops=8, seed=2))
    first = run_stream(eng, cfg)
    second = run_stream(eng, cfg, st=first.state)
    assert first.completed and second.completed
    assert int(second.state.step_no) == 2 * default_steps(8, 3)
    assert second.msg_count.sum() > 0
