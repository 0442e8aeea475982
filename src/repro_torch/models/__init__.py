"""The model families: ``get_model(cfg)`` picks the encoder-decoder stack
(``models/encdec.py``) for family ``"encdec"`` and the decoder-only stack
(``models/transformer.py``) for the others, as ``repro/models`` does;
``param_shapes(cfg)`` is the chosen family's parameter tree,
``param_axes(cfg)`` its leaves' logical axes and ``shard_dims`` what one
process of a ``model`` axis holds of the dims its forward cuts."""
from typing import Callable, Dict, Optional

from repro_torch.core.qat import QATConfig
from repro_torch.models.common import ModelConfig, ShardDims


def get_model(cfg: ModelConfig, qat: Optional[QATConfig] = None,
              qmm: Optional[Callable] = None, dp=None, tp=None):
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.make_model(cfg, qmm, qat=qat, tp=tp, dp=dp)
    from repro_torch.models import transformer
    return transformer.make_model(cfg, qmm, qat=qat, tp=tp, dp=dp)


def param_shapes(cfg: ModelConfig) -> Dict:
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.param_shapes(cfg)
    from repro_torch.models import transformer
    return transformer.param_shapes(cfg)


def param_axes(cfg: ModelConfig) -> Dict:
    if cfg.family == "encdec":
        from repro_torch.models import encdec
        return encdec.param_axes(cfg)
    from repro_torch.models import transformer
    return transformer.param_axes(cfg)


# (sub-tree, leaf) -> (ShardDims field, dim of the stacked leaf): the leaf
# whose resolved spec says whether ``model`` cuts that dim.
_CUT_BY = {("attn", "wq"): ("n_heads", -1),
           ("self_attn", "wq"): ("n_heads", -1),
           ("attn", "wk"): ("n_kv_heads", -1),
           ("self_attn", "wk"): ("n_kv_heads", -1),
           ("mamba", "conv_b"): ("d_inner", -1),
           ("rwkv", "bonus"): ("rwkv_heads", -2)}


def _has_model(entry) -> bool:
    return entry == "model" or (isinstance(entry, tuple) and "model" in entry)


def shard_dims(cfg: ModelConfig, specs, rank: int, size: int) -> ShardDims:
    """What process ``rank`` of a ``model`` axis of ``size`` holds, from
    the parameters' resolved spec tree (``train/state.py::
    state_shardings``): a dim is this process's 1/size when its leaf's
    spec entry holds ``model``, whole otherwise (the kv heads, when
    ``size`` is a multiple of their count: ``ShardDims.kv_gather``). A
    MoE layer's experts go expert-parallel when the rules gave ``model``
    to their ``experts`` dim, FFN-parallel when to ``mlp``
    (``sharding/rules.py``: an axis is used once per spec, and only where
    it divides)."""
    whole = ShardDims.whole(cfg)
    got = dict(n_heads=whole.n_heads, n_kv_heads=whole.n_kv_heads,
               d_inner=whole.d_inner, rwkv_heads=whole.rwkv_heads,
               experts=whole.experts)

    def visit(node, parent=None):
        if isinstance(node, list):
            for v in node:
                visit(v, parent)
        elif isinstance(node, dict):
            for k, v in node.items():
                if isinstance(v, tuple):
                    leaf(parent, k, v)
                else:
                    visit(v, k)

    def leaf(parent, name, spec):
        key = (parent, name)
        if key in _CUT_BY and _has_model(spec[_CUT_BY[key][1]]):
            field = _CUT_BY[key][0]
            if field == "n_kv_heads" and whole.n_kv_heads % size:
                # fewer kv heads than processes: each holds a part of one
                # kv head's columns, and its query heads attend with one
                got.update(n_kv_heads=1, kv_gather=True,
                           kv_offset=rank * whole.n_kv_heads // size)
            else:
                got[field] = getattr(whole, field) // size
        elif key == ("experts", "w_up"):
            if _has_model(spec[1]):
                got.update(moe="experts", experts=whole.experts // size,
                           expert_offset=rank * (whole.experts // size))
            elif _has_model(spec[-1]):
                got["moe"] = "mlp"

    visit(specs)
    return ShardDims(**got)
