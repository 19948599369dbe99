"""Port vs reference: the orchestrator (``repro_torch.orchestrator``).

The orchestrator is numpy-only; the port's package is the reference's
with its imports renamed.  Each unit scenario of
``tests/test_orchestrator.py`` runs against both packages and must give
the same trace (registry state machine, heartbeat deadlines and the
observation ledger, the injector's grammar and seeded schedules, the
workers' runtime draws — bit for bit — and probe decode, the metrics
round trip).  Then whole episodes: the reference and the port run the
same ``kill:w0.1@3,slow:e1@5x2:4.0`` episode from the same initial
params (mode ``off``, 12 rounds, worker threads) to the same events,
replans and counters and losses within 1e-5; replaying the recorded
completion sets reproduces the port's losses bit for bit; the workers'
module imports neither torch nor jax; and the orchestrate CLI runs on
the CPU.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from torch_reference import few_threads, subprocess_env  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ("repro", "repro_torch")


def _ns(pkg):
    """The modules a scenario uses, from one package."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa
    ns = {name: mod(f"orchestrator.{name}") for name in (
        "events", "registry", "heartbeat", "injector", "workers",
        "metrics")}
    ns["Topology"] = mod("core.topology").Topology
    ns["Tolerance"] = mod("core.topology").Tolerance
    ns["HGCCode"] = mod("core.hgc").HGCCode
    return dataclasses.make_dataclass("NS", list(ns))(**ns)


def _registry(ns, m=(2, 2)):
    reg = ns.registry.DeviceRegistry(ns.Topology(m))
    reg.register_all()
    return reg


def _trace(reg):
    return ([(e.kind, e.worker, e.edge, e.step) for e in reg.log.events],
            reg.counts())


# ----------------------------------------------------------------------
# registry
# ----------------------------------------------------------------------
def _registry_lifecycle(ns):
    reg = _registry(ns)
    for f in range(4):
        reg.beat(f, step=0, clock_ms=10.0)
    reg.miss(0, step=1, clock_ms=500.0, suspect_after=1, dead_after=3)
    assert reg.record(0).live
    for k in range(2):
        reg.miss(0, step=2 + k, clock_ms=600.0 + k, suspect_after=1,
                 dead_after=3)
    assert reg.dead_workers() == [0] and reg.live_workers() == [1, 2, 3]
    reg.miss(1, step=4, clock_ms=700.0, suspect_after=1, dead_after=3)
    reg.beat(1, step=5, clock_ms=800.0)
    reg.beat(0, step=5, clock_ms=800.0)
    assert reg.record(0).consecutive_misses == 0
    return _trace(reg)


def _registry_illegal(ns):
    reg = _registry(ns)
    reg.miss(0, step=0, clock_ms=100.0, suspect_after=1, dead_after=2)
    reg.miss(0, step=1, clock_ms=200.0, suspect_after=1, dead_after=2)
    errors = []
    with pytest.raises(ValueError, match="illegal liveness transition") as e:
        reg._transition(reg.record(1), ns.registry.DEAD, 0, 0.0,
                        ns.events.WORKER_DEAD)
    errors.append(str(e.value))
    with pytest.raises(ValueError, match="already registered") as e:
        reg.register(0, 0)
    errors.append(str(e.value))
    return _trace(reg), errors


def _registry_edge_down(ns):
    reg = _registry(ns, (2, 3))
    for f in range(5):
        reg.beat(f, step=0, clock_ms=1.0)
    for f in (0, 1):
        for k in range(3):
            reg.miss(f, step=k, clock_ms=10.0 * k, suspect_after=1,
                     dead_after=3)
    assert reg.edge_down(0) and reg.down_edges() == [0]
    reg.beat(0, step=9, clock_ms=500.0)
    assert not reg.edge_down(0)
    return _trace(reg)


@pytest.mark.parametrize("scenario", [_registry_lifecycle, _registry_illegal,
                                      _registry_edge_down],
                         ids=["lifecycle", "illegal", "edge_down"])
def test_registry_matches_reference(scenario):
    assert scenario(_ns("repro_torch")) == scenario(_ns("repro"))


# ----------------------------------------------------------------------
# heartbeat
# ----------------------------------------------------------------------
def _hb_config_errors(ns):
    msgs = []
    for kw, match in ((dict(interval_ms=100, timeout_ms=50), "below interval"),
                      (dict(backoff=0.5), "backoff"),
                      (dict(suspect_after=3, dead_after=1), "suspect_after")):
        with pytest.raises(ValueError, match=match) as e:
            ns.heartbeat.HeartbeatConfig(**kw)
        msgs.append(str(e.value))
    return msgs


def _hb_flap_and_backoff(ns):
    hb = ns.heartbeat
    reg = _registry(ns)
    mon = hb.HeartbeatMonitor(reg, hb.HeartbeatConfig(
        interval_ms=100, timeout_ms=100, backoff=2.0, suspect_after=1,
        dead_after=3))
    for f in range(4):
        mon.deliver(hb.Heartbeat(f, sent_ms=0.0, runtime_ms=200.0), step=0)
    for f in range(1, 4):
        mon.deliver(hb.Heartbeat(f, sent_ms=150.0, runtime_ms=210.0), step=1)
    ticks = [mon.tick(1, now_ms=150.0), mon.tick(1, now_ms=190.0)]
    mon.deliver(hb.Heartbeat(0, sent_ms=195.0, runtime_ms=400.0), step=2)
    assert ticks == [1, 0] and reg.state_of(0) == ns.registry.HEALTHY
    return ticks, mon.beats_total, mon.misses_total, _trace(reg)


def _hb_ledger(ns):
    reg = _registry(ns)
    mon = ns.heartbeat.HeartbeatMonitor(
        reg, ns.heartbeat.HeartbeatConfig(miss_fill_factor=2.0))
    rows = [mon.record_round({0: 100.0, 1: 120.0, 2: 80.0})
            for _ in range(2)]
    assert rows[0][3] == 240.0 and rows[1][3] == 2.0 * rows[0][3]
    return ([r.tolist() for r in rows], mon.observation_matrix().tolist(),
            mon.observation_matrix(window=1).shape)


def _hb_fit_cluster(ns):
    topo = ns.Topology((2, 2))
    reg = ns.registry.DeviceRegistry(topo)
    reg.register_all()
    mon = ns.heartbeat.HeartbeatMonitor(reg)
    rng = np.random.default_rng(0)
    for _ in range(8):
        base = rng.uniform(90, 110, size=4)
        base[3] *= 5.0
        mon.record_round({f: float(base[f]) for f in range(4)})
    fitted = mon.fit_cluster(D=4.0)
    assert fitted.topo == topo
    assert fitted.params.c[3] > 3.0 * fitted.params.c[0]
    return (np.asarray(fitted.params.c).tolist(),
            fitted.detector.state_dict())


@pytest.mark.parametrize("scenario", [_hb_config_errors,
                                      _hb_flap_and_backoff, _hb_ledger,
                                      _hb_fit_cluster],
                         ids=["config", "flap_backoff", "ledger",
                              "fit_cluster"])
def test_heartbeat_matches_reference(scenario):
    assert scenario(_ns("repro_torch")) == scenario(_ns("repro"))


# ----------------------------------------------------------------------
# injector
# ----------------------------------------------------------------------
def _inj_parse(ns):
    S = ns.injector.InjectionSchedule
    sched = S.parse("kill:w0.1@3, slow:e1@5x3:4.0, partition:w1.0@2x2")
    assert S.parse(sched.spec()).spec() == sched.spec()
    errors = []
    for bad in ("explode:w0.1@3", "kill:w0@3", "kill:x0.1@3",
                "slow:e1@5x3:0.5", "kill:w0.1"):
        with pytest.raises(ValueError) as e:
            S.parse(bad)
        errors.append(str(e.value))
    return sched.spec(), [x.to_json() for x in sched.injections], errors


def _inj_windows(ns):
    inj_mod = ns.injector
    topo = ns.Topology((2, 3))
    inj = inj_mod.Injection(kind="slow", step=5, edge=1, worker=None,
                            duration=3, factor=2.0)
    kill = inj_mod.Injection(kind="kill", step=3, edge=0, worker=1)
    fi = inj_mod.FailureInjector(inj_mod.InjectionSchedule([inj, kill]),
                                 topo)
    out = []
    for step in range(10):
        eff = fi.effects(step)
        out.append((sorted(eff.killed), sorted(eff.slow.items()),
                    [x.kind for x in eff.started],
                    [eff.slow_factor(f) for f in range(6)]))
    return out, fi.applied, inj.targets(topo), kill.targets(topo)


def _inj_seeded(ns, seed=7):
    topo = ns.Topology((3, 3))
    a = ns.injector.InjectionSchedule.seeded(seed, topo, steps=20,
                                             n_events=6)
    kills = [x for x in a.injections if x.kind == "kill"]
    assert len(kills) <= 1 and all(x.worker is not None for x in kills)
    return a.spec()


@pytest.mark.parametrize("case", ["parse", "windows", "seeded_0",
                                  "seeded_7", "seeded_8", "seeded_123"])
def test_injector_matches_reference(case):
    def run(ns):
        if case == "parse":
            return _inj_parse(ns)
        if case == "windows":
            return _inj_windows(ns)
        return _inj_seeded(ns, int(case.split("_")[1]))

    assert run(_ns("repro_torch")) == run(_ns("repro"))


# ----------------------------------------------------------------------
# workers: runtime draws and the probe algebra
# ----------------------------------------------------------------------
@pytest.mark.parametrize("flat,step,seed,D,slow", [
    (2, 5, 3, 4.0, 1.0), (2, 5, 3, 4.0, 4.0), (0, 0, 0, 1.0, 1.0),
    (7, 11, 42, 3.5, 2.5)])
def test_runtime_draws_bit_for_bit(flat, step, seed, D, slow):
    draws = []
    for pkg in PKGS:
        w = _ns(pkg).workers
        row = w.ModelRow(c=10, gamma=0.05, tau_w=20, p_w=0.1, tau_e=30,
                         p_e=0.1)
        draws.append(w.draw_runtime_ms(row, flat=flat, step=step, seed=seed,
                                       D=D, slow_factor=slow))
    assert draws[0] == draws[1]


@pytest.mark.parametrize("probe_seed", [1234, 7])
def test_probe_partials_decode_like_reference(probe_seed):
    def run(ns):
        w = ns.workers
        topo = ns.Topology((3, 3, 3))
        code = ns.HGCCode.build(topo, ns.Tolerance(1, 1), K=9)
        dim = 16
        partials = {}
        for i in range(3):
            for j in range(3):
                coeffs = code.worker_coeffs(i, j)
                p = np.zeros(dim)
                for k in code.assignment.worker_parts(i, j):
                    p += coeffs[k] * w.probe_part_vector(probe_seed, k, dim)
                partials[topo.flat_index(i, j)] = p
        lam = code.collapsed_weights((0, 1), [(0, 2), (1, 2), ()])
        decoded = sum(lam[f] * partials[f] for f in partials if lam[f] != 0)
        truth = w.probe_true_sum(probe_seed, code.K, dim)
        np.testing.assert_allclose(decoded, truth, rtol=1e-8, atol=1e-9)
        return decoded.tolist(), truth.tolist()

    assert run(_ns("repro_torch")) == run(_ns("repro"))


def test_worker_pool_thread_backend_kill_and_stale_drop():
    w = _ns("repro_torch").workers
    topo = _ns("repro_torch").Topology((1, 2))
    rows = [w.ModelRow(c=5, gamma=0.1, tau_w=5, p_w=0.1, tau_e=5,
                       p_e=0.1)] * 3
    with pytest.raises(ValueError, match="unknown worker backend"):
        w.resolve_backend("fiber")
    with w.WorkerPool(topo, rows, seed=0, backend="thread") as pool:
        def work(s):
            return w.WorkItem(step=s, clock_ms=0.0, coeffs=np.ones(3),
                              parts=(0,), D=1.0, probe_seed=1)

        for f in range(3):
            assert pool.dispatch(f, work(0))
        res = pool.collect(0, {0, 1, 2}, timeout_s=30.0)
        assert sorted(res) == [0, 1, 2]
        assert pool.kill(1) and not pool.kill(1)
        assert not pool.dispatch(1, work(1))
        pool.inject_message(("result", res[0]))  # stale: dropped
        for f in (0, 2):
            pool.dispatch(f, work(1))
        res1 = pool.collect(1, {0, 2}, timeout_s=30.0)
        assert sorted(res1) == [0, 2]
        assert all(r.step == 1 for r in res1.values())
        ref = _ns("repro").workers
        assert [r.runtime_ms for _, r in sorted(res1.items())] == [
            ref.draw_runtime_ms(ref.ModelRow(*dataclasses.astuple(rows[0])),
                                f, 1, 0, 1.0) for f in (0, 2)]
    with pytest.raises(ValueError, match="one ModelRow per worker"):
        w.WorkerPool(topo, rows[:2])


# ----------------------------------------------------------------------
# metrics and the event log
# ----------------------------------------------------------------------
def _metrics_roundtrip(ns, path):
    ev, m = ns.events, ns.metrics
    sink = m.MetricsSink(path)
    with pytest.raises(KeyError, match="unknown counter"):
        sink.bump("oops")
    sink.bump("replans")
    sink.bump("heartbeat_misses", 3)
    sink.iteration(
        step=0, clock_ms=123.4, loss=2.5, iter_ms=120.0, fast_e=(0, 1),
        fast_w=[(0, 1), (2,), ()], n_results=5, n_counted=3,
        straggler_hit=True, decode_ok=True, heartbeat_misses=1,
        states={"HEALTHY": 5},
        round_events=[ev.Event(kind=ev.REPLAN, step=0, clock_ms=1.0)],
        wall_us=456.7)
    sink.summary(steps=1, jit_cache_entries=-1, final_loss=2.5,
                 episode_ms=123.4, detect_to_replan_ms=50.0)
    sink.close()
    got = m.read_metrics(path)
    with open(path, "a") as f:
        f.write(json.dumps({"record": "iteration", "schema": 999}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        m.read_metrics(path)
    return got, sorted(m.COUNTERS), m.METRICS_SCHEMA_VERSION


def _event_log(ns):
    ev = ns.events
    log = ev.EventLog()
    log.append(ev.Event(kind=ev.REPLAN, step=0, clock_ms=1.0))
    first = [e.kind for e in log.drain_new()]
    assert log.drain_new() == []
    log.append(ev.Event(kind=ev.SHRINK, step=1, clock_ms=2.0))
    with pytest.raises(ValueError, match="unknown event kind"):
        ev.Event(kind="explosion", step=0, clock_ms=0.0)
    return first, [e.kind for e in log.drain_new()], log.counts()


@pytest.mark.parametrize("case", ["roundtrip", "event_log"])
def test_metrics_match_reference(tmp_path, case):
    def run(pkg):
        if case == "event_log":
            return _event_log(_ns(pkg))
        got, counters, schema = _metrics_roundtrip(
            _ns(pkg), os.fspath(tmp_path / f"{pkg}.jsonl"))
        for rec in got["iteration"]:
            rec.pop("wall_us", None)
        return got, counters, schema

    assert run("repro_torch") == run("repro")


# ----------------------------------------------------------------------
# whole episodes
# ----------------------------------------------------------------------
EPISODE = "kill:w0.1@3,slow:e1@5x2:4.0"


def _episode(pkg, params=None, steps=12, inject=EPISODE, seed=0,
             metrics_path=None):
    api = importlib.import_module(f"{pkg}.api")
    orch_mod = importlib.import_module(f"{pkg}.orchestrator")
    cfg_mod = importlib.import_module(f"{pkg}.configs.registry")
    cfg = dataclasses.replace(cfg_mod.get_smoke_config("llama3-8b"),
                              dtype="float32")
    kw = dict(planner=api.FixedPlanner(s_e=1, s_w=1), total_steps=40,
              mode="off", seed=seed, seq_len=16, verbose=False)
    if pkg == "repro_torch":
        kw.update(params=params, device="cpu")
    sess = api.CodedSession(api.CodedCluster.hetero(3, 3), cfg, **kw)
    orch = orch_mod.Orchestrator(
        sess, orch_mod.OrchestratorConfig(steps=steps, backend="thread",
                                          collect_timeout_s=30.0),
        schedule=orch_mod.InjectionSchedule.parse(inject),
        metrics=orch_mod.MetricsSink(metrics_path))
    return sess, orch, orch.run_episode()


def _replan_rounds(orch):
    return [e.step for e in orch.log.events if e.kind == "replan"]


def test_episode_matches_reference():
    from repro.checkpoint.store import _flatten

    ref_sess, ref_orch, ref_sum = _episode("repro")
    init = _flatten(_episode_initial_params())
    sess, orch, summ = _episode("repro_torch", params=init)
    assert summ["jit_cache_entries"] == -1
    assert ref_sum["jit_cache_entries"] == 1
    for key in ("counters", "event_counts", "injections", "steps",
                "backend"):
        assert summ[key] == ref_sum[key], key
    assert orch.registry.dead_workers() == ref_orch.registry.dead_workers() \
        == [1]
    assert summ["event_counts"]["worker_dead"] == 1
    assert summ["counters"]["replans"] >= 1
    assert summ["counters"]["decode_fallbacks"] == 0
    assert _replan_rounds(orch) == _replan_rounds(ref_orch)
    assert summ["episode_ms"] == ref_sum["episode_ms"]
    assert len(sess.losses) == 12
    np.testing.assert_allclose(sess.losses, ref_sess.losses, rtol=0,
                               atol=1e-5)


def _episode_initial_params():
    """The reference session's initial params (seed 0)."""
    import jax

    from repro.configs.registry import get_smoke_config
    from repro.models import transformer as ref_tf

    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    return jax.tree.map(np.asarray, ref_tf.init_params(
        jax.random.PRNGKey(0), cfg))


def test_replay_parity_from_metrics(tmp_path):
    """Replaying the recorded completion sets into a fresh port session
    reproduces the losses bit for bit (metrics faithfulness)."""
    from repro_torch.api import CodedCluster, CodedSession, FixedPlanner
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.orchestrator import read_metrics

    path = str(tmp_path / "orch.jsonl")
    sess, _, _ = _episode("repro_torch", steps=8, seed=11,
                          inject="slow:e1@2x2:3.0,partition:w2.0@5x1",
                          metrics_path=path)
    records = read_metrics(path)["iteration"]
    cfg = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")
    fresh = CodedSession(CodedCluster.hetero(3, 3), cfg,
                         planner=FixedPlanner(s_e=1, s_w=1), total_steps=40,
                         mode="off", seed=11, seq_len=16, verbose=False,
                         device="cpu")
    for r in records:
        assert r["n_counted"] > 0
        m = fresh.external_step(tuple(r["fast_e"]),
                                [tuple(w) for w in r["fast_w"]])
        assert float(m["loss"]) == r["loss"]
    assert fresh.losses == sess.losses


def test_workers_import_neither_torch_nor_jax():
    script = (
        "import sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.orchestrator.workers as w\n"
        "import repro_torch.orchestrator as o\n"
        "assert o.WorkerPool is w.WorkerPool\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'jax', 'repro') and sys.modules[m] is not None)\n"
        "assert not bad, bad\n"
        "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                       env=subprocess_env(),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "OK" in r.stdout, r.stdout + r.stderr


def test_orchestrate_cli_smoke_on_cpu(tmp_path):
    out = tmp_path / "orch.jsonl"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.orchestrate", "--smoke",
         "--device", "cpu", "--steps", "6", "--backend", "thread",
         "--seq-len", "16", "--inject", "kill:w0.1@3",
         "--expect-zero-recompile", "--metrics-out", str(out)],
        cwd=REPO, env=subprocess_env(),
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    summary = json.loads(r.stdout[r.stdout.index("{"):])
    assert summary["steps"] == 6 and summary["jit_cache_entries"] == -1
    assert "zero-recompile check skipped" in r.stderr
    assert len(out.read_text().splitlines()) == 7  # 6 rounds + summary
