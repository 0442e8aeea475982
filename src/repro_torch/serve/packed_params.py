"""Packed-MX serving parameters: packed leaves all the way to the GEMM.

Counterpart of ``repro/serve/packed_params.py`` (serving subset). The serving
tree keeps every quantized projection packed — ``MXTensor`` leaves (int8 /
uint8 codes + E8M0 scales) for >= 5-bit formats, split-N ``PackedInt4Leaf``
for MXINT4 — so a decode step streams only codes and scales. Layout rules:
stacked leaves are (G, K, N), and MoE expert leaves (G, E, K, N), with the
contraction at ndim-2; scales are in the moved-last (G, [E,] N, K/bs)
layout; a leaf sliced to one layer (and one expert) keeps its stale
``block_axis`` (consumers re-derive the axis as ndim-2).

Tensor-parallel serving (``ElasticEngine(mesh=...)``): ``packed_param_specs``
places a packed tree on a mesh (codes follow the dense weight's logical
axes, scales the moved-last layout), ``repack_splitn_for_tp`` re-nibbles
the column-sharded split-N leaves shard by shard, ``local_shard`` cuts the
tree to one process's shard, and ``weight_stream_bytes_local`` counts what
that process streams.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.anchor import AnchorModel
from repro_torch.core.formats import MXFormat, get_format
from repro_torch.core.mx import MXTensor, dequantize
from repro_torch.core.packed import (pack_int4, pack_int4_splitn, splitn_ok,
                                     unpack_int4, unpack_int4_splitn)
from repro_torch.core.tree import flatten_paths, tree_map, unflatten_paths
from repro_torch.kernels.ops import ss_convert, ss_convert_int4_splitn


@dataclasses.dataclass
class PackedInt4Leaf:
    packed: torch.Tensor         # uint8 nibble pairs, codes.numel() / 2
    scale_exp: torch.Tensor
    shape: tuple                 # original codes shape
    block_axis: int
    fmt_name: str
    # "splitn": codes shape with the last (output) axis halved; byte col j =
    #   output cols (j, j + N/2) — the int4 GEMM kernel's layout.
    # "splitk": legacy — block axis moved last, adjacent nibble pairs along
    #   it; densify-only (no kernel reads it).
    layout: str = "splitn"


def is_packed_leaf(w) -> bool:
    return isinstance(w, (MXTensor, PackedInt4Leaf))


def pack_leaf_int4(t: MXTensor, layout: str = "splitn") -> PackedInt4Leaf:
    assert t.fmt.kind == "int" and t.fmt.bits == 4
    if layout == "splitn" and not splitn_ok(t.codes.shape, t.block_axis):
        layout = "splitk"
    if layout == "splitn":
        packed = pack_int4_splitn(t.codes)
    else:
        packed = pack_int4(torch.movedim(t.codes, t.block_axis, -1))
    return PackedInt4Leaf(packed=packed.contiguous(), scale_exp=t.scale_exp,
                          shape=tuple(t.codes.shape),
                          block_axis=t.block_axis, fmt_name=t.fmt.name,
                          layout=layout)


def layer_slice(leaf, g: int):
    """Leaf ``g`` of a stacked (G, ...) leaf: views, no copies. Packed
    containers keep their (now stale) metadata, like a scan-sliced leaf.
    Applied again to a layer's (E, K, N) expert leaf it gives expert
    ``g``'s 2-D (K, N) slice, the operand of the dequant-GEMM dispatch.
    A packed (G, n) leaf blocked along G itself (rwkv6-7b's ``mix_*`` at
    32 layers, ROADMAP C.11) has no block of its own per layer: its row
    ``g`` comes from the whole leaf densified (float32), a copy."""
    if is_packed_leaf(leaf) and leaf.block_axis == 0:
        return densify_leaf(leaf, None, torch.float32)[g]
    if isinstance(leaf, MXTensor):
        return MXTensor(codes=leaf.codes[g], scale_exp=leaf.scale_exp[g],
                        fmt=leaf.fmt, block_axis=leaf.block_axis)
    if isinstance(leaf, PackedInt4Leaf):
        return dataclasses.replace(leaf, packed=leaf.packed[g],
                                   scale_exp=leaf.scale_exp[g])
    return leaf[g]


def leaf_block_size(p: PackedInt4Leaf) -> int:
    """The block size the leaf was packed at, from its own shapes (never the
    registry default: anchors quantize at arbitrary block sizes)."""
    k = p.packed.shape[-2] if p.layout == "splitn" \
        else p.packed.shape[-1] * 2
    return k // p.scale_exp.shape[-1]


def leaf_as_mx(p: PackedInt4Leaf, block_size: Optional[int] = None,
               block_axis: Optional[int] = None) -> MXTensor:
    """Unpack a PackedInt4Leaf back to an MXTensor view (int8 codes)."""
    ax = p.block_axis if block_axis is None else block_axis
    bs = leaf_block_size(p) if block_size is None else block_size
    if p.layout == "splitn":
        codes = unpack_int4_splitn(p.packed)
    else:
        codes = torch.movedim(unpack_int4(p.packed), -1, ax)
    return MXTensor(codes=codes, scale_exp=p.scale_exp,
                    fmt=get_format(p.fmt_name, bs), block_axis=ax)


def densify_leaf(leaf, block_size: Optional[int], dtype,
                 serving_axis: bool = False) -> torch.Tensor:
    """One packed container -> dense weight; other leaves pass through.

    ``serving_axis=True`` re-derives the contraction axis as ndim-2 (leaves
    sliced per layer keep stale ``block_axis``); ``block_size=None`` derives
    the int4 block size from the leaf's shapes.
    """
    if isinstance(leaf, MXTensor):
        ax = max(leaf.codes.ndim - 2, 0) if serving_axis else leaf.block_axis
        return dequantize(dataclasses.replace(leaf, block_axis=ax),
                          dtype=dtype)
    if isinstance(leaf, PackedInt4Leaf):
        ax = max(leaf.packed.ndim - 2, 0) if serving_axis else None
        return dequantize(leaf_as_mx(leaf, block_size, block_axis=ax),
                          dtype=dtype)
    return leaf


def anchor_block_size(anchor: AnchorModel) -> int:
    """The block size the anchor was actually quantized at."""
    for t in anchor.quantized.values():
        return t.fmt.block_size
    return get_format(anchor.fmt_name).block_size


def make_packed_params(anchor: AnchorModel, *, target_fmt: str | None = None,
                       dtype=torch.bfloat16):
    """Param tree whose quantized leaves are packed MX containers.

    ``target_fmt`` (default: the anchor's own) names a same-kind format at
    or below the anchor's precision: the anchor is Slice-and-Scaled to it in
    the packed domain and kept as MXTensor leaves, except 4-bit MXINT, which
    is nibble-packed into split-N ``PackedInt4Leaf``s. Float leaves are cast
    to ``dtype``.
    """
    fmt_t = get_format(target_fmt or anchor.fmt_name,
                       anchor_block_size(anchor))
    out = {k: convert_leaf(t, fmt_t) for k, t in anchor.quantized.items()}
    for k, w in anchor.raw.items():
        out[k] = w.to(dtype) if w.is_floating_point() else w
    return unflatten_paths(out)


def convert_leaf(t: MXTensor, fmt_t: MXFormat):
    """One anchor leaf (stacked or not) in its served container at
    ``fmt_t``, by one B5 launch into its final buffers on a CUDA tensor:
    4-bit MXINT in the split-N layout with the nibble packing fused, other
    formats as MXTensor leaves. The split-K fallback (block axis last, or
    an odd last axis) packs the converted codes afterwards."""
    if not (fmt_t.kind == "int" and fmt_t.bits == 4):
        return ss_convert(t, fmt_t)
    if not splitn_ok(t.codes.shape, t.block_axis):
        return pack_leaf_int4(ss_convert(t, fmt_t))
    packed, scales = ss_convert_int4_splitn(t, fmt_t)
    return PackedInt4Leaf(packed=packed, scale_exp=scales,
                          shape=tuple(t.codes.shape),
                          block_axis=t.block_axis, fmt_name=fmt_t.name)


def weight_stream_bytes(params) -> int:
    """Device bytes one decode step streams for the weight tree: codes and
    scales at their stored width for packed leaves, plus every float leaf."""
    total = 0
    for _, leaf in flatten_paths(params):
        if isinstance(leaf, MXTensor):
            parts = (leaf.codes, leaf.scale_exp)
        elif isinstance(leaf, PackedInt4Leaf):
            parts = (leaf.packed, leaf.scale_exp)
        else:
            parts = (leaf,)
        total += sum(p.numel() * p.element_size() for p in parts)
    return total


def packed_param_specs(packed_params, axes_tree, mesh, rules=None):
    """Specs (``sharding/rules.py``) for a packed tree: each container
    becomes a container of specs (codes or packed bytes, and scales), each
    raw leaf a spec. Codes shard with the dense weight's logical axes;
    scales follow the moved-last layout (the block axis' name last);
    split-N packed bytes keep the dense order (last dim halved), split-K
    bytes move the block axis last. The reference's
    ``packed_param_shardings``, with specs in place of NamedShardings."""
    from repro_torch.sharding.rules import spec_for_axes

    def spec(shape, axes):
        return spec_for_axes(tuple(shape), axes, mesh, rules)

    def container(leaf, axes):
        if not is_packed_leaf(leaf):
            return spec(leaf.shape, axes)
        ax = leaf.block_axis
        moved = tuple(a for i, a in enumerate(axes) if i != ax) + (axes[ax],)
        if isinstance(leaf, MXTensor):
            return dataclasses.replace(
                leaf, codes=spec(leaf.codes.shape, axes),
                scale_exp=spec(leaf.scale_exp.shape, moved))
        packed_axes = axes if leaf.layout == "splitn" else moved
        return dataclasses.replace(
            leaf, packed=spec(leaf.packed.shape, packed_axes),
            scale_exp=spec(leaf.scale_exp.shape, moved))

    return tree_map(container, packed_params, axes_tree)


def _shards(entry, sizes) -> int:
    """How many pieces a spec entry cuts its dim into on a mesh."""
    if entry is None:
        return 1
    n = 1
    for a in (entry if isinstance(entry, tuple) else (entry,)):
        n *= sizes[a]
    return n


def repack_splitn_for_tp(packed_params, specs, mesh):
    """Re-nibble the split-N int4 leaves whose output (N) axis is sharded.

    Split-N byte column ``j`` pairs output columns ``(j, j + N/2)``: a
    global interleave. Cut contiguously, a shard's bytes would decode to a
    permuted column set, while the row-parallel consumer (wo / w_down) cuts
    its contraction rows contiguously. So each shard's contiguous slice is
    repacked as a self-contained split-N layout of its own ``N/tp``
    columns: the local unpack yields exactly the local columns, and B2
    reads a valid split-N operand (its dims come from the local shapes).
    Split-K leaves and k-sharded split-N leaves slice cleanly and pass
    through, as do leaves whose last axis is split by size-1 axes only."""
    from repro_torch.sharding.rules import mesh_sizes
    sizes = mesh_sizes(mesh)

    def fix(leaf, spec):
        if not (isinstance(leaf, PackedInt4Leaf) and leaf.layout == "splitn"):
            return leaf
        pspec = spec.packed
        last = pspec[-1] if len(pspec) == leaf.packed.ndim else None
        n_shards = _shards(last, sizes)
        if n_shards <= 1:
            return leaf
        codes = unpack_int4_splitn(leaf.packed)
        n = codes.shape[-1]
        if n % (2 * n_shards):
            raise ValueError(f"cannot repack split-N leaf with N={n} over "
                             f"{n_shards} shards")
        n_loc = n // n_shards
        packed = torch.cat(
            [pack_int4_splitn(codes[..., s * n_loc:(s + 1) * n_loc])
             for s in range(n_shards)], dim=-1)
        return dataclasses.replace(leaf, packed=packed.contiguous())

    return tree_map(fix, packed_params, specs)


def local_shard(tree, specs, mesh, coords=None):
    """The shard of ``tree`` (a weight tree, packed or raw) that the process
    at ``coords`` ({axis: index}; default ``mesh.coords``) holds under
    ``specs``: each dim with a spec entry is cut into as many contiguous
    pieces as the entry's axes have (the first axis major, as a
    ``PartitionSpec`` reads), and this process's piece is copied out, so
    every local leaf is contiguous. Container metadata stays global
    (``shape``), as in a JAX array's shard."""
    from repro_torch.sharding.rules import mesh_sizes
    sizes = mesh_sizes(mesh)
    coords = mesh.coords if coords is None else coords
    coords = coords or {}

    def cut(t, spec):
        idx = []
        for dim, entry in zip(t.shape, spec):
            n = _shards(entry, sizes)
            if n == 1:
                idx.append(slice(None))
                continue
            k = 0
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                k = k * sizes[a] + coords.get(a, 0)
            step = dim // n
            idx.append(slice(k * step, (k + 1) * step))
        return t[tuple(idx)].contiguous()

    def one(leaf, spec):
        if isinstance(leaf, MXTensor):
            return dataclasses.replace(
                leaf, codes=cut(leaf.codes, spec.codes),
                scale_exp=cut(leaf.scale_exp, spec.scale_exp))
        if isinstance(leaf, PackedInt4Leaf):
            return dataclasses.replace(
                leaf, packed=cut(leaf.packed, spec.packed),
                scale_exp=cut(leaf.scale_exp, spec.scale_exp))
        return cut(leaf, spec)

    return tree_map(one, tree, specs)


def weight_stream_bytes_local(local_params) -> int:
    """Per-chip weight-stream bytes: the number the per-chip roofline of a
    tensor-parallel engine is seeded with. The reference sizes each leaf's
    shard from its sharding; a process of the port holds only its own
    shard (``local_shard``), so this is that tree's ``weight_stream_bytes``
    (about 1/tp of the global tree's, plus the replicated norms)."""
    return weight_stream_bytes(local_params)
