"""The plain reference of a coded training cell's first steps.

What an exact hierarchical gradient code must decode to, worked out
without the program's code.  Each edge (pod) sums its workers' messages
into a partial (eq. 25); the master adds the partials of the edges whose
messages arrive.  A completion set of one edge makes that edge's partial
the whole decoded gradient and the other's zero, whatever the code's
coefficients: for a dense model, the gradient of the mean token loss
over the step's ``K`` dataset parts, taken part by part.  An expert
layer's routing (its capacity and its load-balancing loss) counts the
tokens of one forward, so for a mixture of experts the reference runs
every (edge, worker) group's rows as one forward, as a worker does: the
groups and their rows come from the paper's cyclic placement, each
part's loss is shared equally among the arriving groups that hold it (so
every part counts once), and every group's load-balancing loss counts
with weight ``AUX_WEIGHT / groups`` in its own edge's partial,
stragglers' included.

The edge→master hop is the codec's definition: each edge's partial plus
its error-feedback residual, cut into blocks of ``grad_block``, each
block scaled by its max |x| / 127, rounded half to even and clipped to
±127; the residual keeps what the rounding lost; the master adds the
dequantized payloads.  Then the global-norm clip, the cosine schedule
and AdamW, in float32.

Returns per-step losses, the first step's clipped gradient norm per
leaf, and each leaf's change after the followed steps.
"""
from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from portbench import data, weights
from portbench.reference import model as ref


def schedule(base_lr: float, warmup: int, total: int, step: int) -> float:
    """Linear warm-up to ``base_lr``, then a cosine to 0 at ``total``."""
    if step < warmup:
        return base_lr * step / max(warmup, 1)
    prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return base_lr * 0.5 * (1.0 + math.cos(math.pi * prog))


def _batch(seed, step, parts, rows, seq, vocab, device):
    toks, tgts = zip(*(data.part_tokens(seed, step, k, rows, seq, vocab)
                       for k in parts))
    t = torch.from_numpy(np.concatenate(toks)).to(device)
    g = torch.from_numpy(np.concatenate(tgts)).to(device)
    return t, g


def int8_roundtrip(x: torch.Tensor, block: int) -> torch.Tensor:
    """``x`` through blockwise symmetric int8 and back (float32)."""
    flat = x.reshape(-1)
    n = flat.numel()
    blocks = torch.nn.functional.pad(flat, (0, (-n) % block)).view(-1, block)
    scale = blocks.abs().amax(1) / 127.0
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(blocks / safe[:, None]).clamp_(-127, 127)
    return (q * scale[:, None]).reshape(-1)[:n].view_as(x)


def _pod_partial(W, m, tr, seed, step, pod, fast_e, fast_w, device, quant,
                 fault) -> float:
    """Accumulate edge ``pod``'s partial into ``W``'s ``.grad``; → its
    share of the step's loss."""
    seq, rows, K = tr["seq_len"], tr["part_batch"], tr["K"]
    vocab = m["vocab"]
    parts = list(range(K))
    denom = float(K * rows * seq)
    if fault == "half_batch":  # half the parts, the mean over the rest
        parts, denom = parts[: K // 2], denom / 2
    loss = 0.0
    if not m.get("n_experts", 0):
        if len(fast_e) != 1:
            raise ValueError("a dense reference needs one arriving edge")
        if pod != fast_e[0]:
            return 0.0
        for k in parts:
            t, g = _batch(seed, step, [k], rows, seq, vocab, device)
            obj, l_k, _ = ref.objective(W, m, t, g, torch.ones_like(
                t, dtype=torch.float32), denom, quant=quant, remat=False)
            obj.backward()
            loss += float(l_k)
        return loss
    cl = tr["cluster"]
    n, mw = cl["n_edges"], cl["n_workers"]
    place = data.cyclic_assignment(n, mw, tr["s_e"], tr["s_w"], K)
    fast = {(i, j) for i in fast_e for j in fast_w[i]}
    holders = {k: sum(k in place[i][j] for i, j in fast) for k in parts}
    aux_coef = ref.AUX_WEIGHT / (n * mw)
    for j in range(mw):
        held = place[pod][j]
        t, g = _batch(seed, step, held, rows, seq, vocab, device)
        w = torch.zeros(t.shape, dtype=torch.float32, device=device)
        if (pod, j) in fast:
            for r, k in enumerate(held):
                if k in holders:
                    w[r * rows:(r + 1) * rows] = 1.0 / holders[k]
        obj, l_g, _ = ref.objective(W, m, t, g, w, denom, aux_coef,
                                    quant=quant, remat=True)
        obj.backward()
        loss += float(l_g)
    return loss


def _step(W, m, tr, seed, step, residual, device, quant, fault):
    """One step's decoded gradient (leaf → tensor) and loss."""
    cl = tr["cluster"]
    fast_e, fast_w = data.completion_set(seed, step, cl["n_edges"],
                                         cl["n_workers"], tr["s_e"],
                                         tr["s_w"])
    decoded = {k: torch.zeros_like(v) for k, v in W.items()}
    loss = 0.0
    for pod in range(cl["n_edges"]):
        loss += _pod_partial(W, m, tr, seed, step, pod, fast_e, fast_w,
                             device, quant, fault)
        with torch.no_grad():
            for k, p in W.items():
                target = residual[k][pod]
                if p.grad is not None:
                    target.add_(p.grad)
                    p.grad = None
                sent = int8_roundtrip(target, tr["grad_block"])
                target.sub_(sent)  # the residual keeps what was lost
                decoded[k].add_(sent)
    return decoded, loss


def run(m: Dict, tr: Dict, seed: int, steps: int, device,
        quant: str = "", fault: str = "") -> Dict:
    """The reference's first ``steps`` steps from the run's weights.

    ``quant="fp8"``: the control; ``fault="half_batch"``: the fault of a
    step that leaves half of its batch out."""
    keys = sorted(weights.param_shapes(m).items())
    W = {k: weights.draw(k, s, seed, device, torch.float32).requires_grad_()
         for k, s in keys}
    state = {k: (torch.zeros_like(v), torch.zeros_like(v))
             for k, v in W.items()}
    if tr["grad_compression"] != "int8":
        raise ValueError("the reference follows the int8 hop only")
    pods = tr["cluster"]["n_edges"]
    residual = {k: torch.zeros((pods,) + tuple(v.shape), device=device)
                for k, v in W.items()}
    b1, b2, eps = 0.9, 0.999, 1e-8
    losses: List[float] = []
    grad_norms: Dict[str, float] = {}
    with ref.exact_f32():
        for step in range(steps):
            gs, loss = _step(W, m, tr, seed, step, residual, device, quant,
                             fault)
            losses.append(loss)
            with torch.no_grad():
                norm = torch.sqrt(sum(torch.sum(g * g) for g in gs.values()))
                scale = torch.clamp(tr["grad_clip"] / (norm + 1e-9), max=1.0)
                lr = schedule(tr["lr"], tr["warmup_steps"], tr["total_steps"],
                              step)
                t = step + 1
                for k, p in W.items():
                    g = gs[k] * scale
                    if step == 0:
                        grad_norms[k] = float(torch.linalg.vector_norm(g))
                    mo, ve = state[k]
                    mo.mul_(b1).add_(g, alpha=1 - b1)
                    ve.mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (mo / (1 - b1 ** t)) / (
                        torch.sqrt(ve / (1 - b2 ** t)) + eps)
                    p.sub_(lr * upd)
            del gs
    del state, residual
    change: Dict[str, float] = {}
    with torch.no_grad():
        for k, s in keys:
            p0 = weights.draw(k, s, seed, device, torch.float32)
            change[k] = float(torch.linalg.vector_norm(W[k] - p0))
            del p0
    return {"losses": losses, "grad_norms": grad_norms, "change": change}
