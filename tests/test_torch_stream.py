"""The port's closed-loop ``run_stream`` against the reference.

* It reproduces the deterministic keys of ``benchmarks/BENCH_baseline.json``
  for the eight closed-loop ``streaming.*`` configs (``r8_h2`` with two
  homes) and the three ``subsets.*`` configs, fed the reference's
  ``[T, R]`` workload arrays, and passes its own oracle validation.
* On one small config per case it matches ``repro``'s ``run_stream``
  directly: counters, message counts and the retirement trace,
  bit-identical.
* The loop stops at quiescence (fewer ``engine.step`` calls than the
  budget) and still equals the reference's run of the whole budget,
  dense, packed, two homes, open loop under admission and observed; a
  budget that ends first, and an observed run with an injection, step
  every step.

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

from repro import traffic as J  # noqa: E402
from repro.traffic import (EngineConfig as JEngineConfig,  # noqa: E402
                           StreamConfig as JStreamConfig,
                           WorkloadSpec as JWorkloadSpec,
                           run_stream as j_run_stream,
                           summarize as j_summarize)
from repro_torch import convert, spans  # noqa: E402
from repro_torch.traffic import (ArrivalSchedule,  # noqa: E402
                                 EngineConfig, ObserveConfig, StreamConfig,
                                 Workload, WorkloadSpec, default_steps,
                                 run_stream, summarize, validate_run)

BASELINE = json.loads((pathlib.Path(__file__).resolve().parents[1]
                       / "benchmarks" / "BENCH_baseline.json").read_text())
KEYS = ("ops_per_step", "inval_per_excl_grant", "max_wait",
        "mean_mshr_occupancy", "ops_retired", "steps")
#: baseline key -> (workload, remotes, width, homes); all at 16 lines,
#: 32 ops.
CONFIGS = {
    "r2": ("zipfian", 2, 1, 1),
    "r8": ("zipfian", 8, 1, 1),
    "r32": ("zipfian", 32, 1, 1),
    "r8_w2": ("zipfian", 8, 2, 1),
    "producer_consumer_r8": ("producer_consumer", 8, 1, 1),
    "migratory_r8": ("migratory", 8, 1, 1),
    "false_sharing_r8": ("false_sharing", 8, 1, 1),
    "r8_h2": ("zipfian", 8, 1, 2),
}


def _reference_workload(name, R, L, ops, seed=0, legacy_bits=True,
                        params=()):
    spec = JWorkloadSpec(name, ops=ops, seed=seed, params=params)
    if legacy_bits:
        with jax.threefry_partitionable(False):
            wl = spec.materialize(R, L)
    else:
        wl = spec.materialize(R, L)
    return Workload(*(np.array(x) for x in wl))


@pytest.mark.parametrize("key", list(CONFIGS))
def test_baseline_deterministic_keys(key):
    name, R, W, H = CONFIGS[key]
    ops, L = 32, 16
    steps = default_steps(ops, R)
    run = run_stream(EngineConfig(remotes=R, lines=L, homes=H).build("cpu"),
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
    validate_run(run, n_homes=H)


#: ``benchmarks/bench_smoke.py``'s SUBSET_CONFIG: the baseline keys
#: ``subsets.*`` (R=8, L=16, 32 ops, zipfian, seed 0).
SUBSETS = {"full_moesi": (), "enhanced_mesi": (),
           "read_only": (("store_frac", 0.0),)}


@pytest.mark.parametrize("subset", list(SUBSETS))
def test_baseline_subset_keys(subset):
    R, L, ops = 8, 16, 32
    steps = default_steps(ops, R)
    run = run_stream(
        EngineConfig(remotes=R, lines=L, subset=subset).build("cpu"),
        StreamConfig(workload=_reference_workload(
            "zipfian", R, L, ops, params=SUBSETS[subset]), steps=steps,
            collect_trace=True))
    s = summarize(run.counters, run.msg_count)
    msgs = int(np.asarray(run.msg_count).sum())
    got = {"completed": bool(run.completed),
           "msgs_per_op": round(msgs / max(int(s["ops_retired"]), 1), 6),
           "ops_per_step": round(float(s["ops_per_step"]), 6),
           "ops_retired": int(s["ops_retired"])}
    assert got == BASELINE["subsets"][subset]
    eng_subset = EngineConfig(subset=subset).build("cpu").subset
    validate_run(run, subset=eng_subset)


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


#: case -> (engine fields, stream fields, budget (0: the default), whether
#: the loop stops before the budget); R=3, L=64, B=4, 4 ops a remote.
#: ``observe`` holds ``ObserveConfig`` fields, ``arrivals`` a Poisson
#: rate; an injection lands 4 steps before the budget ends, long after
#: the stream has gone quiet.
QUIET = {
    "dense_w1": ({}, {"width": 1}, 0, True),
    "dense_w2": ({}, {"width": 2}, 0, True),
    "packed_w2": ({"packed": True}, {"width": 2}, 0, True),
    "homes2_w2": ({"homes": 2, "home_bw": 1}, {"width": 2}, 0, True),
    "open_admission": ({}, {"width": 2, "arrivals": 0.3,
                            "admission": (4, 1)}, 0, True),
    "observed": ({}, {"observe": {"capacity": 256}}, 0, True),
    "observed_inject": ({}, {"observe": {"capacity": 256, "inject": -4}},
                        0, False),
    "short_budget": ({}, {"width": 2}, 6, False),
}


@pytest.mark.parametrize("case", list(QUIET))
def test_loop_stops_at_quiescence_as_the_full_budget(case):
    """The loop's steps, read as the ``engine.step`` span's calls, and
    the run against the reference's whole budget: state leaf by leaf,
    every counter (``steps`` among them), messages, trace, completion,
    the open loop's histograms and backlog, the observation digest."""
    ekw, skw, steps, stops = QUIET[case]
    R, L, ops = 3, 64, 4
    wl = JWorkloadSpec("zipfian", ops=ops, seed=11).materialize(R, L)
    jkw, tkw = dict(skw), dict(skw)
    last = 0
    if "arrivals" in skw:
        arr = J.ArrivalSpec("poisson", rate=skw["arrivals"],
                            seed=1).materialize(ops, R)
        last = int(np.asarray(arr.step).max())
        jkw["arrivals"], tkw["arrivals"] = arr, ArrivalSchedule(
            np.array(arr.step))
    budget = steps or default_steps(ops, R, last)
    if "observe" in skw:
        o = dict(skw["observe"])
        if "inject" in o:
            o["inject"] = (budget + o["inject"], 5, 1)
        jkw["observe"], tkw["observe"] = J.ObserveConfig(**o), \
            ObserveConfig(**o)
    jrun = j_run_stream(
        JEngineConfig(remotes=R, lines=L, block=4, **ekw).build(),
        JStreamConfig(workload=wl, steps=steps, collect_trace=True, **jkw))
    spans.reset()
    spans.enable()
    try:
        trun = run_stream(
            EngineConfig(remotes=R, lines=L, block=4, **ekw).build("cpu"),
            StreamConfig(workload=Workload(*(np.array(x) for x in wl)),
                         steps=steps, collect_trace=True, **tkw))
    finally:
        spans.disable()
    ran = spans.summary()["engine.step"]["calls"]
    spans.reset()
    assert (ran < budget) if stops else (ran == budget), (ran, budget)
    assert int(trun.counters.steps) == int(trun.state.step_no) == budget
    assert trun.completed == jrun.completed == (steps == 0)
    np.testing.assert_array_equal(trun.msg_count, jrun.msg_count)
    assert trun.payload_msgs == jrun.payload_msgs
    np.testing.assert_array_equal(trun.trace.retire_step,
                                  jrun.trace.retire_step)
    jctr = jax.tree_util.tree_map(np.asarray, jrun.counters)
    got = convert.counters_to_reference(trun.counters)
    for f in jctr._fields:
        np.testing.assert_array_equal(got[f], getattr(jctr, f), err_msg=f)
    a = convert.flatten(jax.tree_util.tree_map(np.asarray, jrun.state))
    b = convert.flatten(trun.state)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    for f in ("sojourn_hist", "admit_wait_hist"):
        if getattr(jrun, f) is None:
            assert getattr(trun, f) is None
        else:
            np.testing.assert_array_equal(getattr(trun, f),
                                          np.asarray(getattr(jrun, f)))
    assert trun.backlog == jrun.backlog
    if "observe" in skw:
        np.testing.assert_array_equal(trun.obs.words,
                                      np.asarray(jrun.obs.words))
        assert trun.obs.metrics() == jrun.obs.metrics()
        assert [vars(v) for v in trun.obs.violations] == \
            [vars(v) for v in jrun.obs.violations]
        np.testing.assert_array_equal(trun.obs.phase_hist,
                                      jrun.obs.phase_hist)
