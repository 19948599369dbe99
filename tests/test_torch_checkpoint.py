"""Port vs reference: checkpoints, kill/resume, shrink, eval and generate.

The store (``repro_torch.checkpoint.store``) is held against the
reference's ``repro.checkpoint.store``: the same files, manifest and
error messages, and each reads what the other wrote.  The session's
checkpoint path is held against the reference sessions of
``torch_reference`` (one subprocess, shared with
``tests/test_torch_session.py``), llama3-8b smoke config in float32:

  * the reference's checkpoint of an adamw coded_q int8 run killed after
    step 2 resumes in the port, whose steps 2–3 match the reference's
    own resumed run within 1e-5,
  * the port's checkpoint of the same run has the reference's files,
    ``.npz`` keys, shapes and dtypes, and ``meta.json`` / extra keys,
  * ``shrink`` (losses within 1e-5, the surviving pods' EF residual rows
    carried), ``eval_step`` (1e-5) and the greedy tokens of a serve-only
    session (equal).

Inside the port, a killed-then-resumed run equals the uninterrupted one
bit for bit (losses and the trained state), through the session and
through the train CLI.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs.registry import get_config as ref_get_config
from repro.configs.registry import get_smoke_config as ref_get_smoke
from repro_torch import _tree
from repro_torch.api import CodedCluster, CodedSession, planner_for_scheme
from repro_torch.checkpoint import store
from repro_torch.checkpoint.params import _flatten
from repro_torch.configs.registry import get_config, get_smoke_config
from torch_reference import (  # noqa: F401 (few_threads: autouse)
    CKPT,
    FIT,
    GEN,
    REPO,
    SHRINK,
    few_threads,
    reference_dir,
    subprocess_env,
)

CFG = dataclasses.replace(get_smoke_config("llama3-8b"), dtype="float32")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_dir(tmp_path_factory)


@pytest.fixture(scope="module")
def init(reference):
    return dict(np.load(reference / "params.npz"))


def _session(cluster, mode, comp="", planner=None, **kw):
    kw.setdefault("verbose", False)
    return CodedSession(cluster, CFG,
                        planner=planner or planner_for_scheme("hgc", 1, 1),
                        mode=mode, grad_compression=comp, device="cpu", **kw)


def _host_state(session):
    """Flat host copy of everything a checkpoint carries as arrays."""
    out = {"params/" + k: v.detach().numpy().copy()
           for k, v in _flatten(session.params).items()}
    out.update({"opt_state/" + k: v.detach().numpy().copy()
                for k, v in _flatten(session.opt_state).items()})
    for i, r in enumerate(session.residual):
        out[f"residual/{i}"] = r.numpy().copy()
    return out


# ----------------------------------------------------------------------
# the store
# ----------------------------------------------------------------------
def _store_case(mod, case, d):
    """One scenario of ``tests/test_checkpoint_data.py`` /
    ``tests/test_dist_train_elastic.py`` against a store module ``mod``;
    → what it restored, for comparison across the two packages."""
    if case == "roundtrip":
        st = mod.CheckpointStore(d, keep=2, cfg_hash="abc")
        state = {"params": {"w": np.arange(12, dtype=np.float32)
                            .reshape(3, 4)},
                 "opt": {"m": np.zeros(3), "t": np.int32(7)},
                 "nested": [np.ones(2), {"x": np.float64(3.5)}]}
        st.save(10, state, extra={"streams": [{"seed": 1, "step": 5}]})
        return st.restore()
    if case == "keep_n_gc":
        st = mod.CheckpointStore(d, keep=2)
        for s in (1, 2, 3, 4):
            st.save(s, {"x": np.ones(1) * s})
        assert st.manifest()["steps"] == [3, 4]
        assert not os.path.exists(os.path.join(d, "step_0000000001"))
        return st.restore()
    if case == "specific_step":
        st = mod.CheckpointStore(d, keep=5)
        for s in (5, 10):
            st.save(s, {"x": np.ones(1) * s})
        return st.restore(step=5)
    assert case == "array_extra"
    st = mod.CheckpointStore(d, keep=2)
    rng = np.random.default_rng(0)
    residual = {"w": rng.normal(size=(2, 3)).astype(np.float32),
                "layers": [np.ones((2, 4), np.float32),
                           np.zeros((2,), np.float32)]}
    st.save(3, {"params": {"w": np.arange(6, dtype=np.float32)}},
            extra={"streams": [{"seed": 1, "step": 7}],
                   "detector": {"alpha": 0.3, "n_obs": 4,
                                "ewma": [1.5, 2.5]},
                   "ef_residual": residual})
    return st.restore()


def _files(d):
    return sorted(os.path.relpath(os.path.join(r, f), d)
                  for r, _, fs in os.walk(d) for f in fs)


def _assert_same_tree(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        if x.dtype.kind in "fiu":
            assert x.dtype == y.dtype and x.shape == y.shape, k
            np.testing.assert_array_equal(x, y)
        else:
            assert x.tolist() == y.tolist(), k


@pytest.mark.parametrize("case", ["roundtrip", "keep_n_gc", "specific_step",
                                  "array_extra"])
def test_store_matches_reference(tmp_path, case):
    mine = _store_case(store, case, str(tmp_path / "port"))
    theirs = _store_case(ref_store, case, str(tmp_path / "ref"))
    assert _files(tmp_path / "port") == _files(tmp_path / "ref")
    assert mine[0] == theirs[0]
    _assert_same_tree(mine[1], theirs[1])
    _assert_same_tree(mine[2], theirs[2])
    # each package reads what the other wrote
    for mod, other in ((store, "ref"), (ref_store, "port")):
        got = mod.CheckpointStore(str(tmp_path / other)).restore(mine[0])
        _assert_same_tree(got[1], mine[1])
        _assert_same_tree(got[2], mine[2])


def test_store_saves_tensors(tmp_path):
    st = store.CheckpointStore(str(tmp_path), keep=1)
    state = {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "h": torch.ones(2, dtype=torch.bfloat16),
             "t": torch.tensor(3, dtype=torch.int32)}
    st.save(1, state, extra={"r": {"w": torch.full((2, 2), 0.5)}})
    step, got, extra = ref_store.CheckpointStore(str(tmp_path)).restore()
    assert step == 1 and got["t"].dtype == np.int32 and int(got["t"]) == 3
    np.testing.assert_array_equal(got["w"], state["w"].numpy())
    assert got["h"].dtype == np.float32  # numpy has no bfloat16
    np.testing.assert_array_equal(extra["r"]["w"], np.full((2, 2), 0.5))


@pytest.mark.parametrize("case", ["read_by_numpy", "reads_numpy",
                                  "bad_crc", "compressed"])
def test_npz_streams_are_numpys_format(tmp_path, case):
    flat = {"a/b": torch.arange(12.0).reshape(3, 4),
            "t": torch.tensor(3, dtype=torch.int32),
            "h": torch.ones(3, dtype=torch.bfloat16),
            "f": np.asfortranarray(np.arange(6.0).reshape(2, 3)),
            "nc": np.arange(20.0).reshape(4, 5)[:, ::2],
            "e": np.zeros((0, 3), np.float32),
            "b": np.array([True, False])}
    want = {k: store._host(v) for k, v in flat.items()}
    path = str(tmp_path / "x.npz")
    if case == "compressed":
        np.savez_compressed(path, **want)
        with pytest.raises(ValueError, match="compressed"):
            store.read_npz(path)
        return
    if case == "reads_numpy":
        np.savez(path, **want)
        got = store.read_npz(path)
    else:
        assert store.write_npz(path, flat) == sum(
            v.nbytes for v in want.values())
        with np.load(path) as z:
            got = {k: z[k] for k in z.files}
    if case == "bad_crc":
        raw = bytearray(open(path, "rb").read())
        raw[raw.find(b"\x93NUMPY") + 128 + 10] ^= 1  # in a/b's data
        open(path, "wb").write(raw)
        with pytest.raises(zipfile.BadZipFile, match="CRC-32"):
            store.read_npz(path)
        return
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("fault", ["schema_newer", "schema_unstamped",
                                   "config_hash"])
def test_store_errors_match_reference(tmp_path, fault):
    d = str(tmp_path / "ck")
    store.CheckpointStore(d, cfg_hash="aaa").save(1, {"w": np.ones(3)})
    meta_path = os.path.join(d, "step_0000000001", "meta.json")
    meta = json.load(open(meta_path))
    assert meta["schema_version"] == store.SCHEMA_VERSION == \
        ref_store.SCHEMA_VERSION
    if fault == "schema_newer":
        meta["schema_version"] = store.SCHEMA_VERSION + 1
    elif fault == "schema_unstamped":
        del meta["schema_version"]
    json.dump(meta, open(meta_path, "w"))
    cfg_hash = "bbb" if fault == "config_hash" else "aaa"
    msgs = []
    for mod in (store, ref_store):
        with pytest.raises(ValueError) as err:
            mod.CheckpointStore(d, cfg_hash=cfg_hash).restore()
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert ("schema v" if fault != "config_hash" else "config hash") \
        in msgs[0]


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_config_hash_matches_reference(size):
    mine = (get_smoke_config if size == "smoke" else get_config)("llama3-8b")
    theirs = (ref_get_smoke if size == "smoke" else ref_get_config)(
        "llama3-8b")
    assert repr(mine) == repr(theirs)
    assert store.config_hash(mine) == ref_store.config_hash(theirs)


# ----------------------------------------------------------------------
# the session's checkpoints against the reference's
# ----------------------------------------------------------------------
def test_reference_checkpoint_resumes_in_port(reference, tmp_path):
    ck = tmp_path / "ck"
    shutil.copytree(reference / "ck", ck)
    _, saved, extra = store.CheckpointStore(str(ck)).restore()
    s = _session(CodedCluster.homogeneous(2, 4), "coded_q", "int8",
                 checkpoint_dir=str(ck), resume=True, **CKPT)
    assert s._step == 2
    # the restored state is the file's, bit for bit, before any step
    live = _flatten({"params": s.params, "opt_state": s.opt_state})
    assert sorted(live) == sorted(_flatten(saved))
    for key, want in _flatten(saved).items():
        got = live[key]
        assert got.dtype == torch.from_numpy(want).dtype, key
        np.testing.assert_array_equal(got.detach().numpy(), want)
    res = _tree.leaves_like(extra["ef_residual"], s.params)
    assert len(res) == len(s.residual)
    for got, want in zip(s.residual, res):
        np.testing.assert_array_equal(got.numpy(), want)
    assert [x.state_dict() for x in s.streams] == extra["streams"]
    assert s.cluster.detector.state_dict() == extra["detector"]
    want = json.loads((reference / "losses.json").read_text())["resumed"]
    got = s.fit(4, **FIT)["losses"]
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _npz_layout(path):
    with np.load(path) as z:
        return {k: (z[k].shape, z[k].dtype.str) for k in z.files}


def test_port_checkpoint_layout_matches_reference(reference, init, tmp_path):
    ck = tmp_path / "ck"
    s = _session(CodedCluster.homogeneous(2, 4), "coded_q", "int8",
                 checkpoint_dir=str(ck), params=init, **CKPT)
    got = s.fit(4, stop_after=2, **FIT)["losses"]
    want = json.loads((reference / "losses.json").read_text())["killed"]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    ref = reference / "ck"
    assert _files(ck) == _files(ref)
    step = "step_0000000002"
    for name in ("state.npz", "extra.npz"):
        assert _npz_layout(ck / step / name) == _npz_layout(ref / step / name)
    mine = json.loads((ck / step / "meta.json").read_text())
    theirs = json.loads((ref / step / "meta.json").read_text())
    assert sorted(mine) == sorted(theirs)
    assert sorted(mine["extra"]) == sorted(theirs["extra"])
    for key in ("step", "schema_version", "cfg_hash", "n_arrays", "bytes"):
        assert mine[key] == theirs[key], key
    # the elastic state depends on the straggler draws alone: equal
    assert mine["extra"] == theirs["extra"]
    man = json.loads((ck / "manifest.json").read_text())
    assert man == json.loads((ref / "manifest.json").read_text())


@pytest.mark.parametrize("run", ["off_adamw", "coded_sgd", "coded_q_int8",
                                 "coded_q_fp8", "off_grouped_replan"])
def test_kill_resume_bit_for_bit_in_port(init, tmp_path, run):
    mode, comp = {"off_adamw": ("off", ""), "coded_sgd": ("coded", ""),
                  "coded_q_fp8": ("coded_q", "fp8"),
                  "off_grouped_replan": ("off", "")}.get(run,
                                                         ("coded_q", "int8"))
    kw = dict(CKPT, optimizer="sgd" if run == "coded_sgd" else "adamw",
              total_steps=6, params=init)
    fit = dict(FIT)
    cluster = lambda: CodedCluster.homogeneous(2, 4)  # noqa: E731
    kill_at, saved_at = 3, 2
    if run == "off_grouped_replan":
        # the grouped planner on a 3 × 3 hetero cluster replans to
        # s_e = 2 after step 3: the step-4 checkpoint carries a code the
        # resume must rebuild (a GroupedHGCCode)
        kw["planner"] = "grouped"
        cluster = lambda: CodedCluster.hetero(3, 3)  # noqa: E731
        fit = dict(replan_every=1)
        kill_at, saved_at = 5, 4
    whole = _session(cluster(), mode, comp, **kw)
    whole.fit(6, **fit)
    ck = str(tmp_path / "ck")
    killed = _session(cluster(), mode, comp, checkpoint_dir=ck, **kw)
    first_code = killed.code
    killed.fit(6, stop_after=kill_at, **fit)
    resumed = _session(cluster(), mode, comp, checkpoint_dir=ck,
                       resume=True, **kw)
    assert resumed._step == saved_at
    if run == "off_grouped_replan":
        from repro_torch.core.grouping import GroupedHGCCode

        assert isinstance(resumed.code, GroupedHGCCode)
        assert resumed.code.tol != first_code.tol  # rebuilt, not initial
        assert resumed.plan.code is resumed.code
    resumed.fit(6, **fit)
    assert killed.losses[:saved_at] + resumed.losses == whole.losses
    assert resumed.code.tol == whole.code.tol
    a, b = _host_state(whole), _host_state(resumed)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_shrink_matches_reference(reference, init):
    s = _session(CodedCluster.hetero(3, 2), "coded_int8", planner="fixed",
                 params=init, **SHRINK)
    s.fit(3)
    before = s.residual[0].clone()
    assert before.shape[0] == 3
    plan = s.shrink(dead_edges=[1])
    assert s.cluster.topo.n == 2 and plan is s.plan
    after = s.residual[0]
    assert after.shape[0] == 2
    # the surviving pods' live residual rows rode the mesh rebuild
    assert torch.equal(after[0], before[0])
    assert torch.equal(after[1], before[2])
    assert float(after.abs().max()) > 0.0  # not re-zeroed
    s.fit(6)
    want = json.loads((reference / "losses.json").read_text())["shrink"]
    np.testing.assert_allclose(s.losses, want, rtol=0, atol=1e-5)
    ref = np.load(reference / "shrink_residual.npz")
    np.testing.assert_array_equal(ref["after"], ref["before"][[0, 2]])


def test_shrink_record_survives_kill_resume(init, tmp_path):
    def run(ck=""):
        s = _session(CodedCluster.hetero(3, 2), "coded_int8",
                     planner="fixed", params=init, checkpoint_dir=ck,
                     **SHRINK)
        s.fit(3)
        s.shrink(dead_edges=[1])
        return s

    whole = run()
    whole.fit(6)
    killed = run(str(tmp_path / "ck"))
    killed.save_checkpoint()
    resumed = _session(CodedCluster.hetero(3, 2), "coded_int8",
                       planner="fixed", checkpoint_dir=str(tmp_path / "ck"),
                       resume=True, **SHRINK)
    assert resumed.cluster.topo == whole.cluster.topo
    assert resumed.cluster.dead_edges == (1,)
    resumed.fit(6)
    assert resumed.losses == whole.losses[3:]
    for a, b in zip(resumed.residual, whole.residual):
        assert torch.equal(a, b)


def test_shrink_that_breaks_the_plan_raises_structured(init):
    """No (1, 1) code fits 3 + 4 workers: the shrink raises the
    reference's structured error and leaves the session as it was."""
    from repro.api import CodedCluster as RefCluster
    from repro.api import CodedSession as RefSession
    from repro.api import ReplanError as RefReplanError
    from repro.api import planner_for_scheme as ref_planner
    from repro_torch.api import ReplanError

    s = _session(CodedCluster.homogeneous(2, 4), "off", params=init,
                 **SHRINK)
    s.fit(1)
    code, topo = s.code, s.cluster.topo
    with pytest.raises(ReplanError) as err:
        s.shrink(dead_workers=[(0, 1)])
    assert err.value.constraint == "plan" and err.value.topo.m == (3, 4)
    assert s.code is code and s.cluster.topo == topo
    s.fit(2)
    assert len(s.losses) == 2 and np.isfinite(s.losses).all()
    ref = RefSession(RefCluster.homogeneous(2, 4), CFG,
                     planner=ref_planner("hgc", 1, 1), mode="off",
                     verbose=False, **SHRINK)
    with pytest.raises(RefReplanError) as want:
        ref.shrink(dead_workers=[(0, 1)])
    assert str(err.value) == str(want.value)
    assert want.value.constraint == "plan"


def _serve_ref(reference):
    z = np.load(reference / "serve.npz")
    return z, json.loads((reference / "serve.json").read_text())


def test_eval_step_matches_reference(reference, init):
    z, ref = _serve_ref(reference)
    s = CodedSession(None, CFG, params=init, device="cpu", verbose=False)
    got = s.eval_step({k: z[k] for k in ("tokens", "targets", "weights")})
    assert sorted(got) == sorted(ref["eval"])
    for k, v in ref["eval"].items():
        assert abs(got[k] - v) <= 1e-5 * max(1.0, abs(v)), k


def test_generate_matches_reference(reference, init):
    z, ref = _serve_ref(reference)
    s = CodedSession(None, CFG, params=init, device="cpu", verbose=False)
    toks = s.generate(z["prompts"], GEN)
    assert toks.dtype == np.int32 and toks.tolist() == ref["tokens"]
    # the session's serve pair is built once per (max_len, exact)
    s.generate(z["prompts"], GEN)
    assert len(s._serve_cache) == 1


def test_serve_only_session_rejects_training():
    s = CodedSession(None, get_smoke_config("llama3-8b"), device="cpu",
                     verbose=False)
    for call in (lambda: s.fit(1), s.step,
                 lambda: s.external_step((0,), [(0,)])):
        with pytest.raises(RuntimeError, match="serve-only"):
            call()


def test_train_cli_kill_resume_bit_for_bit(tmp_path):
    """The reference SKILL's recipe: ``--stop-after`` then ``--resume``
    with the SAME ``--steps``; the ``--metrics-out`` losses concatenate
    to the uninterrupted run's."""
    base = [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
            "--device", "cpu", "--dist", "coded_q", "--steps", "4",
            "--seq-len", "16", "--log-every", "1", "--force-drop-edge", "1",
            "--force-drop-step", "2"]
    ck = ["--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every",
          "2"]
    env = subprocess_env()
    out = {}
    for name, extra in (("whole", []), ("killed", ck + ["--stop-after", "2"]),
                        ("resumed", ck + ["--resume"])):
        path = tmp_path / f"{name}.json"
        r = subprocess.run(base + extra + ["--metrics-out", str(path)],
                           cwd=REPO, env=env, capture_output=True, text=True,
                           timeout=120)
        assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
        out[name] = json.loads(path.read_text())
        if name == "resumed":
            assert "resumed from step 2" in r.stdout
    assert out["resumed"]["first_step"] == 2
    assert out["killed"]["losses"] + out["resumed"]["losses"] == \
        out["whole"]["losses"]
