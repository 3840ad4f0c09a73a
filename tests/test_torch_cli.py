"""The port's command line and its JSON configs against the reference's.

* ``config_to_json``/``config_from_json`` both ways: the port's document
  reads in ``repro.traffic.config_from_json`` and the reference's in the
  port, the reference's refusals (``tests/test_serving.py``), and the
  reference's ``kernel_backend`` key accepted and dropped;
* ``run.smoke(device="cpu")`` passes every case against the oracle, and
  a failing case is a FAIL line, not a raise (``tests/test_robustness.py``);
* ``main([...])`` with ``--artifacts`` writes the resolved
  ``config.json``, which ``--config`` replays verbatim;
* the CLI's flag checks.
"""
import json

import pytest

torch = pytest.importorskip("torch")

import repro.traffic as jt  # noqa: E402
from repro_torch.traffic import (AdmissionConfig, ArrivalSpec,  # noqa: E402
                                 EngineConfig, ObserveConfig, StreamConfig,
                                 WorkloadSpec, config_from_json,
                                 config_to_json)
from repro_torch.traffic import run as run_mod  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs():
    ecfg = EngineConfig(remotes=4, lines=16, subset="read_only", homes=2,
                        credits=8)
    scfg = StreamConfig(
        workload=WorkloadSpec("zipfian", ops=32, seed=3,
                              params={"store_frac": 0.0}),
        arrivals=ArrivalSpec("bursty", rate=0.25, seed=9,
                             params={"hi_lo_ratio": 8.0}),
        admission=AdmissionConfig(max_inflight=16, reserve=4), width=2,
        observe=ObserveConfig(specs=("req_resp",), inject=(3, 1, 2)))
    return ecfg, scfg


def test_config_json_roundtrip_and_unknown_keys():
    ecfg, scfg = _configs()
    e2, s2 = config_from_json(config_to_json(ecfg, scfg))
    assert e2.to_json_dict() == ecfg.to_json_dict()
    assert s2.to_json_dict() == scfg.to_json_dict()
    assert s2.workload.params == (("store_frac", 0.0),)
    assert s2.observe == scfg.observe
    with pytest.raises(ValueError, match="unknown engine config keys"):
        config_from_json('{"engine": {"remote": 4}}')
    with pytest.raises(ValueError, match="unknown workload"):
        config_from_json('{"stream": {"workload": {"name": "nope"}}}')
    with pytest.raises(ValueError, match="unknown top-level config keys"):
        config_from_json('{"engines": {}}')
    with pytest.raises(ValueError, match="unknown stream config keys"):
        config_from_json('{"stream": {"line_filter": [1]}}')


def test_config_json_packed_and_refusals():
    ecfg = EngineConfig(remotes=8, lines=16, packed=True)
    e2, _ = config_from_json(config_to_json(
        ecfg, StreamConfig(workload=WorkloadSpec("zipfian", ops=8))))
    assert e2.packed is True and e2.to_json_dict() == ecfg.to_json_dict()
    with pytest.raises(ValueError, match="unknown engine config keys"):
        config_from_json('{"engine": {"packed_planes": true}}')
    wl = WorkloadSpec("zipfian", ops=8).materialize(2, 16)
    with pytest.raises(ValueError, match="WorkloadSpec"):
        StreamConfig(workload=wl).to_json_dict()
    with pytest.raises(ValueError, match="ArrivalSpec"):
        StreamConfig(arrivals=ArrivalSpec().materialize(8, 2)) \
            .to_json_dict()
    with pytest.raises(ValueError, match="capture filters"):
        import numpy as np
        StreamConfig(observe=ObserveConfig(),
                     type_filter=np.ones(16, bool)).to_json_dict()


def test_port_document_reads_in_the_reference_and_back():
    ecfg, scfg = _configs()
    text = config_to_json(ecfg, scfg)
    assert "kernel_backend" not in json.loads(text)["engine"]
    je, js = jt.config_from_json(text)
    assert je.kernel_backend == ""
    jdoc = json.loads(jt.config_to_json(je, js))
    assert {k: v for k, v in jdoc["engine"].items()
            if k != "kernel_backend"} == ecfg.to_json_dict()
    assert jdoc["stream"] == json.loads(text)["stream"]
    e2, s2 = config_from_json(jt.config_to_json(je, js))
    assert e2.to_json_dict() == ecfg.to_json_dict()
    assert s2.to_json_dict() == scfg.to_json_dict()


@pytest.mark.parametrize("backend", ["", "xla", "pallas"])
def test_reference_kernel_backend_is_accepted_and_dropped(backend):
    doc = {"engine": {"remotes": 2, "lines": 8,
                      "kernel_backend": backend}, "stream": {}}
    e, _ = config_from_json(json.dumps(doc))
    assert e.to_json_dict() == EngineConfig(remotes=2, lines=8) \
        .to_json_dict()
    assert "kernel_backend" not in e.to_json_dict()


def test_unknown_kernel_backend_is_refused():
    with pytest.raises(ValueError, match="kernel_backend"):
        config_from_json('{"engine": {"kernel_backend": "triton"}}')


def test_smoke_passes_on_the_cpu(capsys):
    assert run_mod.smoke(device="cpu") == 0
    out = capsys.readouterr().out
    assert out.count(": OK") == len(jt.WORKLOADS) + 5
    assert "smoke: PASS" in out


def test_smoke_observed_writes_artifacts(tmp_path, capsys):
    assert run_mod.smoke(observe=True, check_specs=True,
                         artifacts=str(tmp_path), device="cpu") == 0
    out = capsys.readouterr().out
    metrics = json.loads((tmp_path / "smoke_metrics.json").read_text())
    assert len(metrics) == len(jt.WORKLOADS) + 5
    for slug, m in metrics.items():
        obs = m["observability"]
        assert obs["captured_total"] == sum(m["messages"].values()), slug
        assert (tmp_path / f"{slug}.trace.json").exists()
        assert (tmp_path / f"{slug}.perfetto.json").exists()
    assert "read_only" in out and "trace=" in out


def test_smoke_survives_nonassertion_failure(monkeypatch, capsys):
    calls = []

    def fake_drive(name, **kw):
        calls.append(name)
        if name == "migratory":
            raise ValueError("injected shape blow-up")
        return {"ops_retired": 1, "max_wait": [0], "messages": {}}

    monkeypatch.setattr(run_mod, "drive", fake_drive)
    rc = run_mod.smoke(device="cpu")
    out = capsys.readouterr().out
    assert rc == 1
    assert "FAIL ValueError: injected shape blow-up" in out
    assert calls.count("migratory") == 1
    assert out.count(": OK") == len(calls) - 1
    assert "1 FAILURES" in out


def test_main_artifacts_config_replays_verbatim(tmp_path, capsys):
    art = tmp_path / "art"
    run_mod.main(["--device", "cpu", "--remotes", "4", "--lines", "16",
                  "--ops", "12", "--width", "2", "--homes", "2",
                  "--validate", "--artifacts", str(art)])
    first = json.loads(capsys.readouterr().out)
    doc = json.loads((art / "config.json").read_text())
    assert doc == first["config"]
    assert first["completed"] and first["validated"]
    run_mod.main(["--device", "cpu", "--config", str(art / "config.json"),
                  "--validate"])
    second = json.loads(capsys.readouterr().out)
    for out in (first, second):
        out.pop("wall_s")
    assert second == first
    # the port's document replays in the reference's reader too.
    je, js = jt.config_from_json((art / "config.json").read_text())
    assert (je.remotes, je.homes, js.width) == (4, 2, 2)


def test_main_reads_a_reference_config(tmp_path, capsys):
    je = jt.EngineConfig(remotes=3, lines=8, kernel_backend="pallas")
    js = jt.StreamConfig(workload=jt.WorkloadSpec("migratory", ops=6,
                                                  seed=2))
    path = tmp_path / "ref.json"
    path.write_text(jt.config_to_json(je, js))
    run_mod.main(["--device", "cpu", "--config", str(path), "--validate"])
    out = json.loads(capsys.readouterr().out)
    assert out["completed"] and out["workload"] == "migratory"
    assert out["n_remotes"] == 3


@pytest.mark.parametrize("argv,msg", [
    (["--remotes", "65"], "--remotes must be in 1..64"),
    (["--width", "0"], "--width must be >= 1"),
    (["--subset", "nope"], "--subset must be one of"),
    (["--credits", "-1"], "--credits must be >= 0"),
    (["--homes", "0"], "--homes must be >= 1"),
    (["--homes", "3"], "must divide --lines"),
    (["--home-bw", "-1"], "--home-bw must be >= 0"),
    (["--mesh-devices", "-1"], "--mesh-devices must be >= 0"),
    (["--mesh-devices", "2", "--validate"], "out of fleet scope"),
    (["--arrivals", "nope"], "--arrivals must be one of"),
    (["--admit-cap", "4"], "--admit-cap requires --arrivals"),
    (["--arrivals", "poisson", "--admit-cap", "4", "--admit-reserve", "4"],
     "must leave room"),
    (["--device", "tpu"], "--device must be 'cuda' or 'cpu'"),
    (["--device", "cpu", "--mesh-devices", "2"], "CUDA devices"),
])
def test_cli_checks(argv, msg, capsys):
    with pytest.raises(SystemExit) as exc:
        run_mod.main(argv)
    assert exc.value.code == 2
    assert msg in capsys.readouterr().err


def test_cli_without_a_gpu_names_the_cpu(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit) as exc:
        run_mod.main(["--ops", "4"])
    assert exc.value.code != 0
    assert "--device cpu" in capsys.readouterr().err
