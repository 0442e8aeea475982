"""The check that decides ``correct`` for a serving cell.

Once the window has closed and the program's state is freed, a sample of
the requests the run completed, drawn from the seed with the longest of
them in it, is run through the plain float32 reference (``bench/reference``)
over each prompt followed by its served tokens. The reference works the
served weights out again from the seeded float32 leaves: quantized to the
anchor format and Slice-and-Scaled to the served one. For each served
token, the gap is how far the reference's logit of that token lies below
the reference's best logit at that position. A cell compares the widest
gap over the sample (0 when every served token is the reference's
argmax), or, where its limits say so, the mean gap: a sparse-expert cell,
whose bfloat16 router flips near-tied expert picks against the float32
reference, so that its widest gap is a flipped token's in sound runs and
the control's alike.
"""
from __future__ import annotations

import re
from typing import Dict, List

import numpy as np
import torch

from bench.harness import weights
from bench.reference import model as ref
from bench.reference.mx import served_weight

# The MF-QAT protocol quantizes every projection of the decoder stack;
# embeddings, the head, norms, biases and the router stay float32.
QUANTIZED = re.compile(r"\.(wq|wk|wv|wo|w_gate|w_up|w_down)$")


def sample(inputs: List, seed: int, min_tokens: int, max_requests: int):
    """The longest completed request, then others drawn from the seed until
    ``min_tokens`` served tokens are in the sample."""
    if not inputs:
        return []
    rng = np.random.Generator(np.random.PCG64(int(seed) + 1))
    order = sorted(range(len(inputs)),
                   key=lambda i: -(inputs[i][0].size + len(inputs[i][1])))
    picked = [order[0]]
    rest = [order[i] for i in rng.permutation(len(order) - 1) + 1]
    for i in rest:
        if sum(len(inputs[j][1]) for j in picked) >= min_tokens or \
                len(picked) >= max_requests:
            break
        picked.append(i)
    return [inputs[i] for i in picked]


def widest_gap(cell: Dict, seed: int, picked: List, device,
               served_fmt: str) -> Dict:
    cfg = cell["config"]
    ref.no_tf32()
    w = weights.make(cfg, seed, device)
    anchor = cell["anchor"]

    def layer_params(j):
        out = {}
        for name, t in w.items():
            if not name.startswith("blocks."):
                continue
            key = name.rsplit(".", 1)[1]
            out[key] = served_weight(t[j], anchor, served_fmt) \
                if QUANTIZED.search(name) else t[j]
        return out

    seqs, want = [], []
    for prompt, out, _ in picked:
        toks = np.concatenate([prompt, np.asarray(out[:-1], np.int64)])
        seqs.append(torch.as_tensor(toks, device=device))
        want.append(torch.arange(prompt.size - 1, toks.size, device=device))
    with torch.no_grad():
        logits = ref.logits_at(seqs, want, w["embed"], layer_params,
                               w["final_norm"], w["lm_head"], cfg)
    gaps = []
    for lg, (_, out, _) in zip(logits, picked):
        served = torch.as_tensor(out, device=device).long()
        gaps.append(lg.max(-1).values - lg.gather(1, served[:, None])[:, 0])
    first = torch.stack([g[0] for g in gaps])
    gaps = torch.cat(gaps)
    return {"widest_gap": float(gaps.max()),
            "mean_gap": float(gaps.mean()),
            "not_argmax": float((gaps > 0).float().mean()),
            "tokens": int(gaps.numel()),
            "requests": len(picked),
            "widest_first_gap": float(first.max())}
