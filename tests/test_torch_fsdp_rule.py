"""The port's FSDP leaf rule against the reference's fitted specs (CPU).

For all ten full-width configs, on (data, model) meshes of data 2 and 3
ranks and model 1 and 2, the reference's ``fit_pspecs(params_pspecs(…,
fsdp=True, head_aligned=True))`` (built by ``make_test_mesh`` in a
subprocess that sets ``--xla_force_host_platform_device_count`` before
jax is imported, as ``tests/test_sharding_specs.py`` does) gives each
leaf's "data" entry and "model" entry; the port's
``dist.sharding.fsdp_split`` and ``shard_axis`` must put them on the
same dims, in modes ``2d`` and ``dp_only`` (FSDP over "data" and "model"
together, no TP), with the experts over "model" and over "data"
(``moe_ep_axis``).  ``data_axes`` is the 2d "data" view the coded step
stores, and ``state_axis`` maps it onto the optimizer state as the
reference's ``opt_state_pspecs`` does.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.dist import sharding
from torch_reference import REPO

MESHES = [(2, 1), (2, 2), (3, 1), (3, 2)]
LAYOUTS = [("2d", "model"), ("2d", "data"), ("dp_only", "model"),
           ("dp_only", "data")]

_SCRIPT = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=6"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.configs.base import TrainConfig
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.dist import sharding as sh
    from repro.dist.mesh import make_test_mesh
    from repro.launch import steps as steps_lib

    meshes, layouts = json.loads(sys.argv[1]), json.loads(sys.argv[2])

    def key(path):
        return "/".join(k.key if hasattr(k, "key") else f"#{k.idx}"
                        for k in path)

    def entry(e):
        if e is None:
            return None
        return list(e) if isinstance(e, tuple) else [e]

    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        params_abs, opt_abs = steps_lib.abstract_state(cfg, TrainConfig())
        for data, model in meshes:
            mesh = make_test_mesh(1, data, model)
            for mode, ep in layouts:
                specs = sh.fit_pspecs(sh.params_pspecs(
                    params_abs, cfg, mesh, fsdp=True, mode=mode,
                    moe_ep_axis=ep, head_aligned=True), params_abs, mesh)
                flat = jax.tree_util.tree_flatten_with_path(
                    specs, is_leaf=lambda x: isinstance(x, P))[0]
                ospecs = sh.fit_pspecs(sh.opt_state_pspecs(opt_abs, specs),
                                       opt_abs, mesh)
                oflat = jax.tree_util.tree_flatten_with_path(
                    ospecs, is_leaf=lambda x: isinstance(x, P))[0]
                out[f"{arch}|{data}|{model}|{mode}|{ep}"] = {
                    "params": {key(p): [entry(e) for e in s]
                               for p, s in flat},
                    "state": {key(p): [entry(e) for e in s]
                              for p, s in oflat}}
    print("SPECS " + json.dumps(out))
    """
)


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps(MESHES),
                        json.dumps(LAYOUTS)], capture_output=True,
                       text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(x for x in r.stdout.splitlines() if x.startswith("SPECS "))
    return json.loads(line[len("SPECS "):])


def _dim_of(spec, axes):
    """The negative dim of the entry holding any of ``axes`` (mesh axes
    of one rank dropped), and that entry's axes; (None, ()) when none."""
    nd = len(spec)
    for i, e in enumerate(spec):
        kept = tuple(a for a in (e or []) if a in axes)
        if kept:
            return i - nd, kept
    return None, ()


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fsdp_rule_equals_reference_fitted_specs(reference, arch):
    cfg = get_config(arch)
    shapes = sharding._full_shapes(cfg)
    split_leaves = 0
    for data, model in MESHES:
        sizes = {"data": data, "model": model}
        live = tuple(a for a, n in sizes.items() if n > 1)
        for mode, ep in LAYOUTS:
            ref = reference[f"{arch}|{data}|{model}|{mode}|{ep}"]
            assert set(ref["params"]) == set(shapes)
            fsdp_axes = ("data",) if mode == "2d" else ("data", "model")
            for k, shape in shapes.items():
                name = k.rsplit("/", 1)[-1]
                want = _dim_of(ref["params"][k],
                               tuple(a for a in fsdp_axes if a in live))
                got = sharding.fsdp_split(
                    name, shape, {a: sizes[a] for a in fsdp_axes},
                    mode=mode, moe_ep_axis=ep)
                assert (got or (None, ())) == want, (k, mode, ep, data,
                                                     model)
                split_leaves += got is not None
                if mode == "2d" and model > 1:
                    tp_dim = _dim_of(ref["params"][k], ("model",))[0]
                    assert sharding.shard_axis(name, shape, cfg, model,
                                               ep) == tp_dim, (k, ep)
            if mode == "2d" and ep == "model":
                axes = sharding.data_axes(cfg, data)
                for k, spec in ref["state"].items():
                    assert sharding.state_axis(k, axes) == \
                        _dim_of(spec, ("data",))[0], k
    assert split_leaves > 0
