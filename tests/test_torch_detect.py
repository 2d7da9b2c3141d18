"""The port's telemetry channel and health monitor (repro_torch.obs.telemetry,
.detect) against the reference's (repro.obs).

The 9 labeled episodes of benchmarks/bench_detect.py are generated through
the port's simulator, with the algos the port's planner routes, and run
through the port's HealthMonitor: the alarms (kind, step, level, factor
estimate, detail) and the reroute reports must equal the reference's
exactly, and scored as the benchmark scores them they give precision =
recall = 1.0 and no clean false positives. The telemetry stream
round-trips, malformed streams are rejected as the reference rejects them,
and a file written by either package loads under the other's validator.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from benchmarks import bench_detect
from repro.core import engine as jeng
from repro.core import simulator as jsim
from repro.obs import detect as jdetect
from repro.obs import telemetry as jtelemetry
from repro_torch.core import engine as teng
from repro_torch.core import hw, planner
from repro_torch.core import simulator as sim
from repro_torch.obs import detect, telemetry

EPISODES = bench_detect._episodes(smoke=False)
BUCKET_BYTES = bench_detect.BUCKET_BYTES
HIER8 = {"node": 2, "local": 4}
DATA_AXES = ("node", "local")


def _port_spec(spec):
    kw = {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}
    kw["fault"] = sim.FaultSpec(**dataclasses.asdict(spec.fault))
    return sim.EpisodeSpec(**kw)


def _algos(spec, mode):
    if mode == "hier":
        return tuple("hier" for _ in BUCKET_BYTES)
    topo = hw.TOPOLOGIES[spec.topo_name]
    return tuple(planner.choose_allreduce_algo(b, spec.nodes, topo)
                 for b in BUCKET_BYTES)


def _run(case):
    """(port monitor, reference monitor, reference spec) of one episode."""
    jspec, mode = EPISODES[case]
    spec = _port_spec(jspec)
    algos = _algos(spec, mode)
    events = sim.generate_episode(spec, BUCKET_BYTES, algos)
    telemetry.validate_telemetry(events)
    mon = detect.HealthMonitor(bucket_bytes=BUCKET_BYTES, algos=algos,
                               nodes=spec.nodes, topo=spec.topo_name)
    mon.replay(events)
    jalgos = bench_detect._algos(jspec, mode)
    jmon = jdetect.HealthMonitor(bucket_bytes=BUCKET_BYTES, algos=jalgos,
                                 nodes=jspec.nodes, topo=jspec.topo_name)
    jmon.replay(jsim.generate_episode(jspec, BUCKET_BYTES, jalgos))
    return mon, jmon, jspec


@pytest.mark.parametrize("case", range(len(EPISODES)),
                         ids=[s.name for s, _ in EPISODES])
def test_episode_alarms_equal_reference(case):
    mon, jmon, _ = _run(case)
    assert [dataclasses.asdict(a) for a in mon.alarms] == \
        [dataclasses.asdict(a) for a in jmon.alarms]
    assert mon.t_model == jmon.t_model
    assert mon.baseline_step == jmon.baseline_step
    assert mon.baseline_buckets == jmon.baseline_buckets
    for a, ja in zip(mon.alarms, jmon.alarms):
        assert a.describe() == ja.describe()
        assert a.degrade_kwargs() == ja.degrade_kwargs()
        rep, jrep = mon.reroute(a), jmon.reroute(ja)
        assert (rep.old_algos, rep.new_algos, rep.topo_name) == \
            (jrep.old_algos, jrep.new_algos, jrep.topo_name)
        assert rep.summary() == jrep.summary()


def test_episodes_score_as_the_reference_baseline():
    """bench_detect's scoring on the port's alarms: precision = recall =
    1.0, no clean false positives, factors within the reference's."""
    n_correct = n_incorrect = n_faulty = n_detected = clean_fp = 0
    for case in range(len(EPISODES)):
        mon, jmon, jspec = _run(case)
        sc = bench_detect._score(jspec, mon.alarms)
        n_correct += len(sc["correct"])
        n_incorrect += len(sc["incorrect"])
        if jspec.label == "clean":
            clean_fp += len(mon.alarms)
        else:
            n_faulty += 1
            n_detected += bool(sc["correct"])
    assert n_correct == n_faulty == n_detected == 7
    assert n_incorrect == 0 and clean_fp == 0


def test_reroute_under_degraded_inter_goes_through_the_port_planner():
    case = next(i for i, (s, _) in enumerate(EPISODES)
                if s.name == "degraded_inter_0p4")
    mon, _, _ = _run(case)
    rep = mon.reroute(mon.alarms[0])
    assert rep.n_changed > 0 and "re-route" in rep.summary()
    deg = hw.TOPOLOGIES[rep.topo_name].degrade(
        **mon.alarms[0].degrade_kwargs())
    assert rep.new_algos == tuple(
        planner.choose_allreduce_algo(b, 16, deg) for b in BUCKET_BYTES)


def test_detector_config_equals_reference():
    for got, want in ((detect.DetectorConfig(), jdetect.DetectorConfig()),
                      (detect.DetectorConfig.wallclock(),
                       jdetect.DetectorConfig.wallclock())):
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert detect.ALARM_KINDS == jdetect.ALARM_KINDS


def test_warmup_never_alarms():
    cfg = detect.DetectorConfig(warmup_steps=10)
    algos = _algos(_port_spec(EPISODES[0][0]), "routed")
    mon = detect.HealthMonitor(bucket_bytes=BUCKET_BYTES, algos=algos,
                               nodes=16, topo="cloud-virtio-sriov",
                               config=cfg)
    for s in range(cfg.warmup_steps):
        assert mon.observe_step(s, 1.0 + (s % 3)) == []
        assert mon.observe_bucket_times(s, [1e-3 * (s + 1)] * 7) == []
    assert mon.alarms == [] and not mon.in_warmup


def test_step_only_monitor_equals_reference():
    """No bucket model (gspmd, the serve decode loop): the same drift, the
    same step_time_drift alarms, re-armed after recovery."""
    mon, jmon = detect.HealthMonitor(), jdetect.HealthMonitor()
    series = [0.5] * 10 + [1.0] * 10 + [0.5] * 10 + [1.0] * 10
    for s, t in enumerate(series):
        got, want = mon.observe_step(s, t), jmon.observe_step(s, t)
        assert [dataclasses.asdict(a) for a in got] == \
            [dataclasses.asdict(a) for a in want]
    assert [a.kind for a in mon.alarms] == [detect.ALARM_STEP_DRIFT] * 2
    assert mon.observe_bucket_times(0, [1e-3]) == []


@pytest.mark.parametrize("comm", [
    dict(mode="mlsl", wire="int8", hier=True, topo="xeon-shm-10gbe"),
    dict(mode="mlsl", wire="int8", error_feedback=True, hier=True),
    dict(mode="mlsl", wire="fp32")])
def test_from_plan_equals_reference(mesh8, comm):
    """HealthMonitor.from_plan on the port's EnginePlan and the reference's
    on mesh8: the same bucket bytes, routes, node count, topology and
    modeled seconds; replaying the model's own times stays silent."""
    rng = np.random.default_rng(3)
    shapes = {"embed": (32, 8), "w": (64, 16), "head": (8, 32)}
    tree = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}
    jplan = jeng.build_plan(jax.tree_util.tree_map(jax.numpy.asarray, tree),
                            jeng.CommConfig(**comm), mesh8, DATA_AXES)
    tplan = teng.build_plan({k: torch.from_numpy(v) for k, v in tree.items()},
                            teng.CommConfig(**comm), HIER8, DATA_AXES,
                            device="cpu")
    assert tplan.bucket_bytes_list() == jplan.bucket_bytes_list()
    mon = detect.HealthMonitor.from_plan(tplan)
    jmon = jdetect.HealthMonitor.from_plan(jplan)
    assert (mon.bucket_bytes, mon.algos, mon.nodes, mon.topo.name,
            mon.t_model) == (jmon.bucket_bytes, jmon.algos, jmon.nodes,
                             jmon.topo.name, jmon.t_model)
    assert all(t > 0 for t in mon.t_model)
    for s in range(40):
        mon.observe_step(s, 0.5)
        if s % 5 == 0:
            mon.observe_bucket_times(s, list(mon.t_model))
    assert mon.alarms == []


# --------------------------------------------------------------------------
# telemetry channel
# --------------------------------------------------------------------------

def _write(mod, path):
    with mod.TelemetryWriter(path, run_info={"arch": "yi-6b"},
                             sample_every=5) as tel:
        tel.step(step=0, t_step_s=0.5, tok_s=1e4, loss=3.2,
                 exposed_frac=0.1)
        tel.bucket_times(0, [1e-3, 2e-3], modeled=[1.1e-3, 1.9e-3])
        tel.bucket_times(5, modeled=[1.1e-3, 1.9e-3])
        tel.alarm(step=7, kind="straggler", factor=1.5, detail="test")
    return path


def test_telemetry_round_trip(tmp_path):
    events = telemetry.load_telemetry(_write(telemetry,
                                             str(tmp_path / "t.jsonl")))
    assert [e["kind"] for e in events] == ["meta", "step", "bucket_times",
                                           "bucket_times", "alarm"]
    assert events[0]["schema_version"] == telemetry.SCHEMA_VERSION == 1
    assert events[0]["run"]["arch"] == "yi-6b"
    assert events[1]["t_step_s"] == 0.5 and events[1]["loss"] == 3.2
    assert events[2]["measured"] == [1e-3, 2e-3]
    assert events[4]["alarm"] == {"kind": "straggler", "factor": 1.5,
                                  "level": "", "rank": -1,
                                  "detail": "test"}
    # the reference writes the same records (but for the creation time)
    ref = jtelemetry.load_telemetry(_write(jtelemetry,
                                           str(tmp_path / "j.jsonl")))
    for e in (events[0], ref[0]):
        e.pop("created_unix")
    assert events == ref


def test_telemetry_files_validate_across_packages(tmp_path):
    jtelemetry.load_telemetry(_write(telemetry, str(tmp_path / "p.jsonl")))
    telemetry.load_telemetry(_write(jtelemetry, str(tmp_path / "r.jsonl")))
    with open(tmp_path / "p.jsonl", "a") as fh:
        fh.write("not json\n")
    with pytest.raises(ValueError, match="not JSON"):
        telemetry.load_telemetry(str(tmp_path / "p.jsonl"))


def test_telemetry_sampling_knob(tmp_path):
    tel = telemetry.TelemetryWriter(str(tmp_path / "t.jsonl"),
                                    sample_every=25)
    assert tel.should_sample(0) and tel.should_sample(50)
    assert not tel.should_sample(26)
    tel.close()
    off = telemetry.TelemetryWriter(str(tmp_path / "t0.jsonl"),
                                    sample_every=0)
    assert not any(off.should_sample(s) for s in range(100))
    off.close()
    assert telemetry.DEFAULT_SAMPLE_EVERY == jtelemetry.DEFAULT_SAMPLE_EVERY


META = {"kind": "meta", "schema_version": 1, "created_unix": 0.0,
        "sample_every": 25, "run": {}}
BAD_STREAMS = [
    [],                                                     # no meta
    [{"kind": "step", "step": 0, "t_step_s": 1.0}],         # meta not first
    [META, META],                                           # duplicate meta
    [META, {"kind": "wat", "step": 0}],                     # unknown kind
    [META, {"kind": "step", "step": 0}],                    # no t_step_s
    [META, {"kind": "step", "step": True, "t_step_s": 1.0}],  # bool step
    [META, {"kind": "bucket_times", "step": 0}],            # no columns
    [META, {"kind": "bucket_times", "step": 0, "measured": [-1.0]}],
    [META, {"kind": "bucket_times", "step": 0, "modeled": "x"}],
    [META, {"kind": "alarm", "step": 0, "alarm": {"kind": "straggler"}}],
    [META, {"kind": "alarm", "step": 0}],                   # no alarm body
    [META, "not a record"],
    [{**META, "schema_version": 99}],                       # future version
    [{**META, "schema_version": 0}],
]


@pytest.mark.parametrize("bad", range(len(BAD_STREAMS)))
def test_validate_telemetry_rejects_what_the_reference_rejects(bad):
    events = BAD_STREAMS[bad]
    with pytest.raises(ValueError):
        jtelemetry.validate_telemetry(events)
    with pytest.raises(ValueError):
        telemetry.validate_telemetry(events)


def test_bucket_times_requires_a_column(tmp_path):
    tel = telemetry.TelemetryWriter(str(tmp_path / "t.jsonl"))
    with pytest.raises(ValueError):
        tel.bucket_times(0)
    tel.close()
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert [json.loads(x)["kind"] for x in lines] == ["meta"]
