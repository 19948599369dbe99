"""The plain reference of a served request: logits of every served token.

For a request with prompt ``p`` and served tokens ``y_0 … y_{G-1}``
(greedy), the reference runs one float32 forward over ``p ⊕ y_0 …
y_{G-2}`` and reads, at each position that chose a served token, the gap
between its best logit and the served token's; the request's reading is
the widest.  The weights are drawn again from the seed (as served, then
widened to float32 a matmul at a time).  The control reads the same
gaps for the tokens that the reference computed in fp8 puts first.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import weights
from portbench.reference import model as ref


def served_weights(m: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    dt = getattr(torch, m["dtype"])
    return {k: weights.draw(k, s, seed, device, weights.serving_dtype(s, dt))
            for k, s in weights.param_shapes(m).items()}


@torch.no_grad()
def gaps(W, m: Dict, requests: List[Tuple[np.ndarray, np.ndarray]],
         device, control: bool = False) -> List[float]:
    """The widest gap of each ``(prompt, served)`` request; with
    ``control`` the gaps of the fp8 reference's first choices."""
    out = []
    with ref.exact_f32():
        for prompt, served in requests:
            seq = np.concatenate([prompt, served[:-1]])
            t = torch.from_numpy(seq.astype(np.int64)).to(device)
            first = len(prompt) - 1
            z = ref.served_logits(W, m, t, first)
            if control:
                pick = ref.served_logits(W, m, t, first, quant="fp8") \
                    .argmax(-1)
            else:
                pick = torch.from_numpy(served.astype(np.int64)).to(device)
            chosen = torch.gather(z, -1, pick[:, None]).squeeze(-1)
            out.append(float((z.max(-1).values - chosen).max()))
    return out
