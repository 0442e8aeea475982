"""The assigned input-shape set (the same 4 shapes for every LM arch): a
copy of ``repro/configs/shapes.py``, which the cost model's entry-point
terms take.

``train_*`` is a train step; ``prefill_*`` the prefill path; ``decode_*``
/ ``long_*`` a serve step (one new token against a KV cache of seq_len).
``long_500k`` requires sub-quadratic attention: it applies to SSM / hybrid
/ sliding-window archs and not to pure full-attention archs.
"""
import dataclasses

from repro_torch.models.common import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def subquadratic(cfg: ModelConfig) -> bool:
    return (cfg.family in ("ssm", "hybrid")
            or cfg.sliding_window is not None)


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> bool:
    if shape.name == "long_500k" and not subquadratic(cfg):
        return False
    return True


def decode_cache_len(cfg: ModelConfig, shape: ShapeSpec) -> int:
    """KV cache allocation for decode cells: SWA caches are window-bounded."""
    if cfg.sliding_window is not None:
        return min(shape.seq_len, cfg.sliding_window)
    return shape.seq_len
