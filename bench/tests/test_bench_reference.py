"""The reference's plain MX arithmetic equals the program's, bit for bit,
and its forward pass agrees with the program's on the CPU at test widths."""
import numpy as np
import pytest
import torch

from bench.harness import check, weights
from bench.harness.model_config import port_config
from bench.harness import spec
from bench.reference import model as ref
from bench.reference.mx import served_weight
from bench.tests.conftest import FIXTURES


@pytest.mark.parametrize("served", ["mxint8", "mxint6", "mxint4", "mxint3"])
def test_served_weight_bit_exact(served):
    from repro_torch.core.formats import get_format
    from repro_torch.core.mx import dequantize, quantize
    from repro_torch.core.slice_scale import slice_and_scale
    g = torch.Generator().manual_seed(5)
    w = torch.randn(3, 128, 96, generator=g) * 0.02
    w[0, :32, 0] = 0.0                      # an all-zero block
    w[1, 5, 7] = 3.0                        # a block with one outlier
    t = quantize(w, get_format("mxint8"), axis=1)
    want = dequantize(slice_and_scale(t, get_format(served)))
    got = served_weight(w, "mxint8", served)
    assert torch.equal(got, want)


@pytest.mark.parametrize("cell", ["tiny-dense.decode", "tiny-moe.decode"])
def test_reference_matches_program_prefill(cell):
    """The program's monolithic prefill at float32, from the anchor at the
    served format, against the reference's logits at the last position."""
    import dataclasses
    from repro_torch.core.anchor import convert, make_anchor, materialize
    from repro_torch.core.formats import get_format
    from repro_torch.core.qat import QATConfig
    from repro_torch.models import get_model
    c = spec.load_cell(cell, [FIXTURES])
    cfg = c["config"]
    pcfg = dataclasses.replace(port_config(cfg),
                               compute_dtype=torch.float32)
    w = weights.make(cfg, 3, "cpu")
    tree = {}
    for name, t in w.items():
        part = weights.nest(name, t)
        for k, v in part.items():
            if k == "blocks":
                tree.setdefault("blocks", [{}])
                _merge(tree["blocks"][0], v[0])
            else:
                tree[k] = v
    anchor = make_anchor(tree, QATConfig(anchor="mxint8"), device="cpu")
    params = materialize(convert(anchor, get_format(c["format"])),
                         dtype=torch.float32)
    api = get_model(pcfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg["vocab_size"], 40), dtype=torch.int32)
    cache = api.init_cache(1, 64, device="cpu")
    logits, _, _ = api.prefill(params, {"tokens": toks[None],
                                        "lengths": torch.tensor([40])},
                               cache)

    def layer_params(j):
        return {n.rsplit(".", 1)[1]: served_weight(t[j], "mxint8",
                                                   c["format"])
                if check.QUANTIZED.search(n) else t[j]
                for n, t in w.items() if n.startswith("blocks.")}

    ref.no_tf32()
    got = ref.logits_at([toks.long()], [torch.tensor([39])], w["embed"],
                        layer_params, w["final_norm"], w["lm_head"], cfg)[0]
    assert torch.allclose(logits.reshape(-1), got.reshape(-1), atol=2e-4,
                          rtol=1e-4)


def _merge(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _merge(dst.setdefault(k, {}), v)
        else:
            dst[k] = v
