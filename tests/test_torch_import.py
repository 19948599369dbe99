"""The port stands alone: repro_torch imports no jax and nothing of the
reference package, and its entry points refuse to run on the CPU unless
asked to."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        yield ".".join(parts)


def test_port_imports_with_jax_blocked():
    mods = list(_port_modules())
    assert "repro_torch.kernels.ops" in mods
    script = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if (m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('OK', len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    r = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "OK" in r.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_refuse_cpu_without_cuda(monkeypatch):
    from repro_torch.api import serving
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as tf

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3-8b")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tf.init_params(cfg)
    params = tf.init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.generate(params, cfg, [[1, 2, 3]], 2)
    toks = serving.generate(params, cfg, [[1, 2, 3]], 2, device="cpu")
    assert toks.shape == (1, 2)
    from repro_torch.api import CodedSession
    from repro_torch.launch import orchestrate, train

    for entry in (lambda: CodedSession(None, cfg, verbose=False),
                  lambda: train.main(["--smoke"]),
                  lambda: orchestrate.main(["--smoke"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()


def test_registry_names_roadmap_for_unported_archs():
    import dataclasses

    from repro_torch.configs import registry

    # every reference arch is ported: nothing is left to raise
    assert registry.NOT_PORTED == ()
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_config("nope")
    from repro.configs.registry import ARCH_IDS
    from repro.configs.registry import get_config as ref_get_config
    from repro.configs.registry import get_smoke_config as ref_get_smoke

    assert registry.ARCH_IDS == ARCH_IDS
    for arch in registry.ARCH_IDS:
        for mine, theirs in ((registry.get_config(arch), ref_get_config(arch)),
                             (registry.get_smoke_config(arch),
                              ref_get_smoke(arch))):
            assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
            assert mine.param_counts() == theirs.param_counts()
