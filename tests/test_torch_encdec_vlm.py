"""Port vs reference: whisper-medium (encoder–decoder) and qwen2-vl-2b
(M-RoPE, visual embeddings).

Their smoke configs run in float32 on the CPU from the reference's
seeded weights, carried by flat key (the ``tests/test_torch_archs.py``
pattern).  Tolerances: 1e-4 on logits, the loss and the cross cache;
gradients 1e-4 of each leaf's largest value; greedy tokens equal.

qwen2-vl's vision layout (an image's patch grid at ``(t, h, w) = (0,
i // g, i % g)``, the text continuing at ``max + 1`` in all three
streams, as Qwen2-VL lays it out) is held against the reference with
``flash=True``: with its default ``flash=False`` the reference's chunked
attention masks by row 0's temporal positions, so the image's patches
(all at t = 0) see each other, while its flash branch, its decode and
the port mask by index (ROADMAP.md §3).  The default positions (arange
in all three streams) are held against the reference's default config.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import serving as jserving
from repro.checkpoint.store import _flatten
from repro.configs.base import TrainConfig as RefTrainConfig
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import get_smoke_config as ref_smoke
from repro.launch import steps as ref_steps
from repro.models import attention as jattn
from repro.models import transformer as jtf
from repro.optim import make_optimizer as ref_make_optimizer
from repro_torch import _tree
from repro_torch.api import CodedCluster, CodedSession, serving
from repro_torch.checkpoint.params import _flatten as tflatten
from repro_torch.checkpoint.params import params_from_numpy
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.dist.mesh import OneCardMesh
from repro_torch.launch import steps
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.optim import make_optimizer
from torch_reference import (
    RecordingOptimizer,
    coded_q_steps_held,
    reference_dir,
)
from torch_reference import few_threads  # noqa: F401 (autouse)

WHISPER, QWEN = "whisper-medium", "qwen2-vl-2b"
TOL = dict(rtol=1e-4, atol=1e-4)
F32 = dict(dtype="float32", param_dtype="float32")


def _setup(arch, seed=0, **changes):
    """(reference cfg, port cfg, reference params, port params): the
    reference's seeded float32 weights on both sides."""
    ref_cfg = dataclasses.replace(ref_smoke(arch), **F32, **changes)
    cfg = dataclasses.replace(get_smoke_config(arch), **F32)
    jparams = jtf.init_params(jax.random.PRNGKey(seed), ref_cfg)
    flat = {k: np.asarray(v) for k, v in _flatten(jparams).items()}
    return ref_cfg, cfg, jparams, params_from_numpy(flat, "cpu")


def _tokens(seed, B, S, V):
    return np.random.default_rng(seed).integers(0, V, (B, S)).astype(np.int32)


def _frames(seed, cfg, B=2):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.enc_len, cfg.d_model)).astype(
        np.float32)


def vision_positions(B, grid, n_text, shift=True):
    """(3, B, grid² + n_text) int32: a ``grid × grid`` patch grid at
    ``(0, i // grid, i % grid)`` (each row's grid moved down by its row
    index when ``shift``, so that rows differ), then text positions
    from ``max + 1`` on in all three streams."""
    rows = []
    for b in range(B):
        i = np.arange(grid * grid)
        vis = np.stack([np.zeros_like(i), i // grid + b * shift, i % grid])
        start = vis.max() + 1
        text = np.broadcast_to(np.arange(start, start + n_text), (3, n_text))
        rows.append(np.concatenate([vis, text], axis=1))
    return np.stack(rows, axis=1).astype(np.int32)


def _train_params(params):
    for p in _tree.leaves(params):
        p.requires_grad_(True)
    return params


def _leaf_grads(params, cfg, batch):
    """(total, metrics, gradients by flat key) through the train step's
    gradient (``steps._grads``: zeros for a leaf the loss misses)."""
    grads, m = steps._grads(_train_params(params), cfg, batch)
    total = m["loss"] + ttf.AUX_WEIGHT * m["aux_loss"]
    return total, m, tflatten(_tree.unflatten_like(params, grads))


def _check_grads(got, jgrads):
    want = {k: np.asarray(v) for k, v in _flatten(jgrads).items()}
    assert got.keys() == want.keys()
    for key, g in got.items():
        scale = np.abs(want[key]).max()
        np.testing.assert_allclose(g.numpy(), want[key], rtol=0,
                                   atol=1e-4 * scale + 1e-7, err_msg=key)


# ----------------------------------------------------------------------
# configs and layouts
# ----------------------------------------------------------------------
@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_configs_equal_reference(arch):
    for mine, theirs in ((get_config(arch), ref_config(arch)),
                         (get_smoke_config(arch), ref_smoke(arch))):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert mine.param_counts() == theirs.param_counts()


@pytest.mark.parametrize("arch", [WHISPER, QWEN])
def test_init_layout_matches_reference(arch):
    """The port's own init has the reference's flat keys and shapes —
    whisper's ``encoder`` with ``enc_norm`` and the encoder layers'
    unused ``xattn``/``norm_x`` (the reference's ``stack_layers`` gives
    them every layer) — matrices in the working dtype."""
    cfg = get_smoke_config(arch)
    want = {k: np.asarray(v).shape for k, v in _flatten(
        jtf.init_params(jax.random.PRNGKey(0), ref_smoke(arch))).items()}
    got = tflatten(ttf.init_params(cfg, torch.Generator().manual_seed(0),
                                   device="cpu"))
    assert {k: tuple(t.shape) for k, t in got.items()} == want
    for t in got.values():
        assert t.dtype == (torch.bfloat16 if t.ndim >= 2 else torch.float32)
    enc_xattn = {k for k in got if k.startswith("encoder/groups/p0/xattn/")}
    assert (len(enc_xattn) == 4) == (arch == WHISPER)
    if arch == WHISPER:
        assert "encoder/enc_norm/bias" in got
        assert "groups/p0/norm_x/scale" in got


# ----------------------------------------------------------------------
# M-RoPE
# ----------------------------------------------------------------------
@pytest.mark.parametrize("sections,Dh", [((2, 3, 3), 16), ((16, 24, 24), 128)])
def test_mrope_matches_reference(sections, Dh):
    """Distinct streams drive each frequency section; equal streams
    reduce M-RoPE to plain RoPE."""
    rng = np.random.default_rng(Dh)
    x = rng.standard_normal((2, 7, 3, Dh)).astype(np.float32)
    pos = rng.integers(0, 200, (3, 2, 7)).astype(np.int32)
    want = jattn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = tattn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                           sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    flat = torch.from_numpy(pos[1])
    same = tattn.apply_rope(torch.from_numpy(x), flat.expand(3, 2, 7), 1e6,
                            sections)
    plain = tattn.apply_rope(torch.from_numpy(x), flat, 1e6)
    np.testing.assert_allclose(same.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6)
    assert not np.allclose(got.numpy(), plain.numpy(), atol=1e-3)


# ----------------------------------------------------------------------
# qwen2-vl
# ----------------------------------------------------------------------
def _vlm_inputs(cfg, B=2, grid=4, n_text=8, seed=11):
    S = grid * grid + n_text
    toks = _tokens(seed, B, S, cfg.vocab)
    rng = np.random.default_rng(seed + 1)
    vis = rng.standard_normal((B, grid * grid, cfg.d_model)).astype(
        np.float32)
    return toks, vis, vision_positions(B, grid, n_text)


def test_vlm_forward_matches_reference():
    """The vision layout with visual embeddings on the patch positions
    against the reference's flash branch; the default positions against
    the reference's default config."""
    ref_cfg, cfg, jparams, params = _setup(QWEN, seed=1, flash=True)
    toks, vis, pos = _vlm_inputs(cfg)
    jl, _ = jtf.forward(jparams, ref_cfg, jnp.asarray(toks),
                        positions=jnp.asarray(pos),
                        visual_embeds=jnp.asarray(vis))
    tl, _ = ttf.forward(params, cfg, torch.from_numpy(toks).long(),
                        positions=torch.from_numpy(pos),
                        visual_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    default, _ = ttf.forward(params, cfg, torch.from_numpy(toks).long(),
                             visual_embeds=torch.from_numpy(vis))
    assert not np.allclose(default.numpy(), tl.numpy(), atol=1e-3)
    jl, _ = jtf.forward(jparams, dataclasses.replace(ref_cfg, flash=False),
                        jnp.asarray(toks), visual_embeds=jnp.asarray(vis))
    np.testing.assert_allclose(default.numpy(), np.asarray(jl), **TOL)


def test_reference_masks_vision_layout_by_temporal_position():
    """The trap the port is not held to: the reference's two attention
    branches disagree at the vision layout (its chunked branch masks by
    row 0's temporal positions, letting the t = 0 patches attend ahead),
    and the port equals its flash branch, which masks by index."""
    ref_cfg, cfg, jparams, params = _setup(QWEN, seed=1)
    toks, vis, pos = _vlm_inputs(cfg)
    kw = dict(positions=jnp.asarray(pos), visual_embeds=jnp.asarray(vis))
    chunked, _ = jtf.forward(jparams, ref_cfg, jnp.asarray(toks), **kw)
    flash, _ = jtf.forward(jparams, dataclasses.replace(ref_cfg, flash=True),
                           jnp.asarray(toks), **kw)
    assert not np.allclose(np.asarray(chunked), np.asarray(flash), atol=1e-3)
    tl, _ = ttf.forward(params, cfg, torch.from_numpy(toks).long(),
                        positions=torch.from_numpy(pos),
                        visual_embeds=torch.from_numpy(vis))
    np.testing.assert_allclose(tl.numpy(), np.asarray(flash), **TOL)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_vlm_loss_and_gradients_match(remat):
    ref_cfg, cfg, jparams, params = _setup(QWEN, seed=3, flash=True,
                                           remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    toks, vis, pos = _vlm_inputs(cfg, seed=5)
    batch = {"tokens": toks, "targets": _tokens(6, *toks.shape, cfg.vocab),
             "weights": np.random.default_rng(4).random(toks.shape).astype(
                 np.float32),
             "positions": pos, "visual_embeds": vis}
    (jt, jm), jg = jax.value_and_grad(
        lambda p: jtf.loss_and_metrics(
            p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"], tb["targets"] = tb["tokens"].long(), tb["targets"].long()
    total, m, grads = _leaf_grads(params, cfg, tb)
    np.testing.assert_allclose(float(total), float(jt), **TOL)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    _check_grads(grads, jg)


def test_vlm_decode_chain_matches_forward():
    """The counterpart of ``tests/test_decode_consistency.py``: decode
    steps (all three M-RoPE streams at the token's position) equal the
    full forward over the default positions at every position."""
    _, cfg, _, params = _setup(QWEN, seed=9)
    toks = torch.from_numpy(_tokens(10, 2, 20, cfg.vocab)).long()
    full, _ = ttf.forward(params, cfg, toks)
    cache = ttf.init_cache(cfg, 2, max_len=20, device="cpu")
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = ttf.decode_step(params, cfg, toks[:, t:t + 1], cache)
        outs.append(logits)
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)
    assert torch.equal(dec.argmax(-1), full.argmax(-1))


@pytest.mark.parametrize("exact", [False, True], ids=["bulk", "exact"])
def test_vlm_greedy_tokens_match_reference(exact):
    ref_cfg, cfg, jparams, params = _setup(QWEN, seed=7)
    prompt = _tokens(8, 2, 20, cfg.vocab)
    want = jserving.generate(jparams, ref_cfg, prompt, 6,
                             exact_handoff=exact)
    got = serving.generate(params, cfg, prompt, 6, exact_handoff=exact,
                           device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_vlm_coded_q_session_matches_reference(tmp_path_factory):
    """qwen2-vl through the coded_q int8 session (4 steps, edge 1
    dropped at step 2) against the reference's, step by step."""
    assert coded_q_steps_held(reference_dir(tmp_path_factory), QWEN) == 4


# ----------------------------------------------------------------------
# the M-RoPE positions' batch axis (1) in the steps' row splits
# ----------------------------------------------------------------------
def _vlm_batch(cfg, B, seed=12):
    toks, _, pos = _vlm_inputs(cfg, B=B, seed=seed)
    rng = np.random.default_rng(seed)
    return {"tokens": torch.from_numpy(toks).long(),
            "targets": torch.from_numpy(
                _tokens(seed + 1, *toks.shape, cfg.vocab)).long(),
            "weights": torch.from_numpy(rng.random(toks.shape).astype(
                np.float32)),
            "positions": torch.from_numpy(pos),
            "denom": torch.tensor(float(toks.size))}


def test_microbatches_split_mrope_positions_on_their_batch_axis():
    """(3, B, S) positions split on axis 1: the microbatched step equals
    the full-batch one, with rows whose positions differ."""
    _, cfg, _, params = _setup(QWEN, seed=13)
    batch = _vlm_batch(cfg, 4)
    kw = dict(optimizer="sgd", lr=0.05, total_steps=10, warmup_steps=1,
              grad_clip=0.0)
    out = []
    for mb in (0, 2):
        step = steps.make_train_step(cfg, TrainConfig(microbatch=mb, **kw))
        p = _tree.map(lambda t: t.detach().clone().requires_grad_(True),
                      params)
        _, _, m = step(p, step.optimizer.init(p), batch, 1)
        out.append((float(m["loss"]), tflatten(p)))
    (l0, p0), (l1, p1) = out
    assert l1 == pytest.approx(l0, abs=2e-6)
    for key, t in p0.items():
        np.testing.assert_allclose(p1[key].detach().numpy(),
                                   t.detach().numpy(), rtol=0, atol=2e-6,
                                   err_msg=key)


def test_coded_step_selects_mrope_positions_on_their_batch_axis():
    """Each coded group takes its rows of (3, B, S) positions on axis 1:
    the decoded gradient is Σ λ_ij ∇L_ij over the groups' own rows."""
    _, cfg, _, params = _setup(QWEN, seed=14)
    params = _train_params(params)
    mesh, B = OneCardMesh(2, 2), 8
    batch = _vlm_batch(cfg, B)
    lam = np.array([[1.5, 0.0], [0.5, 2.0]], np.float32)
    opt = RecordingOptimizer()
    tcfg = TrainConfig(optimizer="sgd", grad_clip=0.0, dist_mode="coded")
    step = steps._make_dist_train_step(cfg, tcfg, mesh, optimizer=opt)
    _, _, _, metrics = step(params, None, batch, lam, [], 0)
    want, loss = None, 0.0
    for i in range(mesh.pods):
        for j in range(mesh.data):
            rows = mesh.group_rows(i, j, B)
            local = {k: (v[:, rows] if k == "positions"
                         else v[rows] if v.ndim else v)
                     for k, v in batch.items()}
            g, m = steps._grads(params, cfg, local)
            part = [float(lam[i, j]) * x for x in g]
            want = part if want is None else [w + x for w, x in
                                              zip(want, part)]
            loss += float(lam[i, j]) * float(m["loss"])
    for got, w in zip(opt.grads, want):
        scale = w.abs().max().item()
        torch.testing.assert_close(got, w, rtol=0, atol=1e-5 * scale + 1e-9)
    np.testing.assert_allclose(float(metrics["loss"]), loss, rtol=1e-6)


# ----------------------------------------------------------------------
# whisper
# ----------------------------------------------------------------------
def test_encdec_forward_matches_reference():
    ref_cfg, cfg, jparams, params = _setup(WHISPER, seed=1)
    toks, frames = _tokens(2, 2, 12, cfg.vocab), _frames(3, cfg)
    jl, _ = jtf.forward(jparams, ref_cfg, jnp.asarray(toks),
                        enc_frames=jnp.asarray(frames))
    tl, _ = ttf.forward(params, cfg, torch.from_numpy(toks).long(),
                        enc_frames=torch.from_numpy(frames))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    other, _ = ttf.forward(params, cfg, torch.from_numpy(toks).long(),
                           enc_frames=torch.from_numpy(_frames(4, cfg)))
    assert not np.allclose(other.numpy(), tl.numpy(), atol=1e-3)
    # prefill: the same forward with the decoder's self-attention K/V
    jl, jcache = jtf.prefill(jparams, ref_cfg, jnp.asarray(toks),
                             enc_frames=jnp.asarray(frames), last_only=True)
    tl, tcache = ttf.prefill(params, cfg, torch.from_numpy(toks).long(),
                             enc_frames=torch.from_numpy(frames),
                             last_only=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tcache["groups"]["p0"][name].numpy(),
                                   np.asarray(jcache["groups"]["p0"][name]),
                                   **TOL)


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no-remat"])
def test_encdec_loss_and_gradients_match(remat):
    """Including the encoder layers' unused ``xattn``/``norm_x``: zero
    gradients in both packages."""
    ref_cfg, cfg, jparams, params = _setup(WHISPER, seed=3, remat=remat)
    cfg = dataclasses.replace(cfg, remat=remat)
    batch = {"tokens": _tokens(5, 2, 12, cfg.vocab),
             "targets": _tokens(6, 2, 12, cfg.vocab),
             "weights": np.random.default_rng(4).random((2, 12)).astype(
                 np.float32),
             "enc_frames": _frames(7, cfg)}
    (jt, jm), jg = jax.value_and_grad(
        lambda p: jtf.loss_and_metrics(
            p, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()}),
        has_aux=True)(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tb["tokens"], tb["targets"] = tb["tokens"].long(), tb["targets"].long()
    total, m, grads = _leaf_grads(params, cfg, tb)
    np.testing.assert_allclose(float(total), float(jt), **TOL)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), **TOL)
    _check_grads(grads, jg)
    unused = [k for k in grads if k.startswith("encoder/groups/p0/")
              and ("/xattn/" in k or "/norm_x/" in k)]
    assert len(unused) == 6  # wq wk wv wo, scale, bias
    jflat = _flatten(jg)
    for key in unused:
        assert not grads[key].any() and not np.asarray(jflat[key]).any()
    assert grads["encoder/groups/p0/attn/wq"].abs().max() > 0


def test_fill_cross_cache_matches_reference():
    ref_cfg, cfg, jparams, params = _setup(WHISPER, seed=2)
    frames = _frames(8, cfg)
    jc = jtf.fill_cross_cache(jparams, ref_cfg, jnp.asarray(frames),
                              jtf.init_cache(ref_cfg, 2, 16,
                                             dtype="float32"))
    tc = ttf.fill_cross_cache(params, cfg, torch.from_numpy(frames),
                              ttf.init_cache(cfg, 2, 16, device="cpu"))
    for name in ("xk", "xv"):
        got = tc["groups"]["p0"][name]
        assert tuple(got.shape) == (cfg.n_layers, 2, cfg.enc_len,
                                    cfg.n_kv_heads * cfg.head_dim)
        np.testing.assert_allclose(got.numpy(),
                                   np.asarray(jc["groups"]["p0"][name]),
                                   **TOL)
    assert int(tc["cross_pos"]) == cfg.enc_len - 1


def test_encdec_decode_chain_matches_forward():
    """Decode steps, each with its cross block through the decode
    attention over the filled cross cache at ``q_pos = Ce − 1``, equal
    the full forward with the same frames at every position."""
    _, cfg, _, params = _setup(WHISPER, seed=9)
    toks = torch.from_numpy(_tokens(10, 2, 16, cfg.vocab)).long()
    frames = torch.from_numpy(_frames(11, cfg))
    full, _ = ttf.forward(params, cfg, toks, enc_frames=frames)
    cache = ttf.fill_cross_cache(params, cfg, frames,
                                 ttf.init_cache(cfg, 2, 16, device="cpu"))
    outs = []
    for t in range(toks.shape[1]):
        logits, cache = ttf.decode_step(params, cfg, toks[:, t:t + 1], cache)
        outs.append(logits)
    dec = torch.stack(outs, 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), **TOL)


def test_encdec_greedy_tokens_match_reference_serve():
    """The exact handoff (the cross cache filled first) and greedy decode
    against the reference's ``serving.generate``; the session's
    ``generate`` gives the same tokens."""
    ref_cfg, cfg, jparams, params = _setup(WHISPER, seed=7)
    prompt, frames = _tokens(8, 2, 10, cfg.vocab), _frames(9, cfg)
    want = np.asarray(jserving.generate(jparams, ref_cfg, prompt, 6,
                                        enc_frames=jnp.asarray(frames)))
    got = serving.generate(params, cfg, prompt, 6, enc_frames=frames,
                           device="cpu")
    np.testing.assert_array_equal(got, want)
    s = CodedSession(None, cfg, verbose=False, device="cpu",
                     params={k: np.asarray(v) for k, v in
                             _flatten(jparams).items()})
    np.testing.assert_array_equal(s.generate(prompt, 6, enc_frames=frames),
                                  want)


def test_encdec_without_frames_raises_in_both_packages():
    """A whisper batch without ``enc_frames`` is a ``ValueError`` in the
    reference's ``forward`` and the port's — so the coded session, whose
    batches carry no frames, fails as the reference's does."""
    ref_cfg, cfg, jparams, params = _setup(WHISPER)
    toks = _tokens(1, 2, 8, cfg.vocab)
    batch = {"tokens": toks, "targets": toks}
    with pytest.raises(ValueError, match="enc_frames"):
        jtf.loss_and_metrics(jparams, ref_cfg,
                             {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="enc_frames"):
        ttf.loss_and_metrics(params, cfg, {k: torch.from_numpy(v).long()
                                           for k, v in batch.items()})
    s = CodedSession(CodedCluster.homogeneous(2, 2), cfg, total_steps=1,
                     seq_len=8, verbose=False, device="cpu")
    with pytest.raises(ValueError, match="enc_frames"):
        s.fit(1)


def test_encdec_train_step_matches_reference():
    """``make_train_step`` (adamw) on a batch that carries ``enc_frames``,
    two steps against the reference's (its ``test_arch_smoke`` step)."""
    ref_cfg, cfg, jparams, params = _setup(WHISPER, seed=4)
    b = {"tokens": _tokens(12, 2, 10, cfg.vocab),
         "targets": _tokens(13, 2, 10, cfg.vocab),
         "weights": np.ones((2, 10), np.float32),
         "enc_frames": _frames(14, cfg)}
    kw = dict(optimizer="adamw", lr=0.01, total_steps=10, warmup_steps=2,
              grad_clip=1.0)
    rstep = jax.jit(ref_steps.make_train_step(
        ref_cfg, RefTrainConfig(**kw), optimizer=ref_make_optimizer("adamw")))
    jp = jparams
    js = ref_make_optimizer("adamw").init(jp)
    tstep = steps.make_train_step(cfg, TrainConfig(**kw),
                                  optimizer=make_optimizer("adamw"))
    state = tstep.optimizer.init(_train_params(params))
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    tb["tokens"], tb["targets"] = tb["tokens"].long(), tb["targets"].long()
    for step in range(2):
        jp, js, jm = rstep(jp, js, {k: jnp.asarray(v) for k, v in b.items()},
                           jnp.asarray(step + 1))
        params, state, m = tstep(params, state, tb, step + 1)
        assert np.isfinite(float(m["loss"]))
        assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    # adamw moves an element whose gradient is at rounding level by up to
    # lr·sign in either package (tests/test_torch_train.py's bound)
    mine = tflatten(params)
    for key, w in _flatten(jp).items():
        np.testing.assert_allclose(mine[key].detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-2 * kw["lr"],
                                   err_msg=key)
