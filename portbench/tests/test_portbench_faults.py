"""A run with the timed path broken underneath comes out not correct,
under each cell's own limits: once for each fault the cell can have (a
one-card cell has no exchange between chips to leave out).  The look
for a card is skipped: the cells run tiny, on the CPU."""
from __future__ import annotations

import numpy as np
import pytest

from portbench import check
from portbench.tests import portbench_tiny as tiny

TRAIN = ["granite8b.train_s512", "granitemoe.train_s1024"]


@pytest.mark.parametrize("name", TRAIN)
def test_sound_tiny_run_is_correct(name):
    out = tiny.run(tiny.cell(name))
    assert check.correct(out["checks"]), out["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_its_state_unchanged(name, monkeypatch):
    from repro_torch.launch import steps

    def unchanged(params, opt_state, grads, optimizer, tcfg, lr_at, step,
                  metrics, *a, **k):
        return dict(metrics, lr=lr_at(step), grad_norm=metrics["loss"])

    monkeypatch.setattr(steps, "_finish", unchanged)
    out = tiny.run(tiny.cell(name))
    assert out["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert not check.correct(out["checks"])


@pytest.mark.parametrize("name", TRAIN)
def test_step_that_leaves_half_its_batch_out(name, monkeypatch):
    from repro_torch.api import session as session_lib

    real = session_lib.build_coded_batch

    def half(code, streams, fast_e, fast_w, seq_len, with_lam=True):
        b = real(code, streams, fast_e, fast_w, seq_len, with_lam)
        w = b["weights"].reshape(code.topo.total_workers, -1, seq_len)
        rows = w.shape[1]
        w[:, rows // 2:] = 0.0  # each group's second half left out ...
        w[:, : rows // 2] *= 2.0  # ... and the mean over the rest
        return b

    monkeypatch.setattr(session_lib, "build_coded_batch", half)
    out = tiny.run(tiny.cell(name))
    assert not check.correct(out["checks"]), out["checks"]


def test_served_token_altered_where_it_is_produced(monkeypatch):
    from repro_torch.api import serving

    real = serving.generate
    vocab = tiny.SERVED["vocab"]

    def altered(*a, **k):
        out = np.array(real(*a, **k))
        out[:, -1] = (out[:, -1] + vocab // 2) % vocab
        return out

    monkeypatch.setattr(serving, "generate", altered)
    out = tiny.run(tiny.cell("granite8b.serve_code"))
    assert not check.correct(out["checks"]), out["checks"]


def test_sound_tiny_serving_run_is_correct():
    out = tiny.run(tiny.cell("granite8b.serve_code"))
    assert check.correct(out["checks"]), out["checks"]
