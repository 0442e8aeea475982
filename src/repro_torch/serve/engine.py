"""Packed-weight continuous-batching engine for elastic-precision serving.

Counterpart of ``repro/serve/engine.py`` on its default path: one anchor
checkpoint (MXINT8/MXFP8) stays resident; per-format weight caches hold
packed trees from ``make_packed_params`` (MXTensor leaves, split-N
``PackedInt4Leaf`` at mxint4), built by one Slice-and-Scale pass on first
use. Every projection of every step runs through ``kernels/dispatch.py``:

  fused (default)  the packed leaf goes to the dequant-GEMM kernel — the
                   CUDA kernel on the card, its plain version on the CPU;
  densify          ``fused=False``: each leaf is dequantized at its point of
                   use and multiplied by ``torch.matmul`` (the reference).

Slot lifecycle on the dense KV layout, greedy decoding:

  admit   — every free slot takes the next queued request, prefilled alone
            into that slot (``ModelApi.prefill_slot``); prompts are
            right-padded to power-of-two buckets with exact masking.
  decode  — one ``serve_step`` advances every slot per tick; free slots are
            masked (their cache_len does not advance, their tokens drop).
  retire  — a slot frees when its request reaches ``max_new`` or the cache
            capacity, and is re-admitted on the next tick.

The format is batch-pinned: the policy picks when the engine goes from
drained to busy, and every request admitted while a slot is live inherits
it. The pseudo-format ``"bf16"`` serves dense anchor-precision weights.

Left out of this slice (each refused with a clear error): paged KV, chunked
and mixed admission, speculative decoding, sampling, the logit guard,
snapshots, SLO tiers and tensor parallelism.
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.anchor import AnchorModel, convert, materialize
from repro_torch.core.formats import get_format
from repro_torch.devices import resolve_device
from repro_torch.kernels import mx_matmul
from repro_torch.kernels.dispatch import make_qmm
from repro_torch.models.transformer import ModelApi
from repro_torch.serve.packed_params import (anchor_block_size,
                                             make_packed_params,
                                             weight_stream_bytes)
from repro_torch.serve.policy import FormatPolicy

DENSE_BF16 = "bf16"   # pseudo-format: dense anchor-precision weights

MIN_PREFILL_BUCKET = 8


def _bucket_len(plen: int, cap: int) -> int:
    """Smallest power-of-two bucket >= plen (floor MIN_PREFILL_BUCKET),
    clamped to the cache capacity ``cap``."""
    b = MIN_PREFILL_BUCKET
    while b < plen:
        b *= 2
    return min(b, cap)


class RequestStatus(str, enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    COMPLETED = "completed"              # reached max_new / cache capacity
    FAILED_CAPACITY = "failed_capacity"  # prompt longer than the cache


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    fmt_used: Optional[str] = None
    done: bool = False
    ttft_s: Optional[float] = None  # generate() entry to first token
    status: RequestStatus = RequestStatus.QUEUED
    error: Optional[str] = None


_UNSUPPORTED = {
    "kv_layout": ("dense", "paged KV is the next slice of the port"),
    "prefill_chunk": (None, "chunked admission is not ported yet"),
    "scheduler": (None, "the mixed scheduler is not ported yet"),
    "speculative": (None, "speculative decoding is not ported yet"),
    "mesh": (None, "tensor-parallel serving is not ported yet"),
    "logit_guard": (False, "the logit guard is not ported yet"),
    "fault_injector": (None, "fault injection is not ported yet"),
}


class ElasticEngine:
    """Continuous-batching engine serving from packed MX weight caches.

    ``fused``: None or True runs packed leaves through the dequant-GEMM
    kernels; False selects the densify reference contract. ``packed=False``
    serves every format from densified weights instead. ``device`` holds
    the weights and caches ("cuda" unless the caller asks for "cpu").
    """

    def __init__(self, api: ModelApi, anchor: AnchorModel, *,
                 batch_slots: int = 4, max_len: int = 256,
                 policy: Optional[FormatPolicy] = None, packed: bool = True,
                 fused: Optional[bool] = None, device="cuda",
                 **unsupported):
        for name, value in unsupported.items():
            if name not in _UNSUPPORTED:
                raise TypeError(f"unexpected argument {name!r}")
            default, why = _UNSUPPORTED[name]
            if value != default:
                raise NotImplementedError(f"{name}={value!r}: {why}")
        self.device = resolve_device(device)
        self.anchor = anchor
        self.slots = batch_slots
        self.max_len = max_len
        self.policy = policy or FormatPolicy(anchor.fmt_name)
        self.packed = packed
        self.fused = fused is None or fused
        self.api = api
        self._block_size = anchor_block_size(anchor)
        self._packed_api = api.with_qmm(
            make_qmm(mode="kernel" if self.fused else "densify"))
        self._weights: Dict[str, object] = {}
        self.current_fmt: Optional[str] = None
        self._fmt_swaps = 0
        self._ticks = 0
        self._prefills = 0
        self._tokens_out = 0
        self._prefill_s = 0.0           # host wall time in admissions
        self._decode_s = 0.0            # host wall time in decode steps
        self._nonfinite_rows = 0        # consumed logit rows with NaN/Inf
        self._status_counts: Dict[str, int] = {}

    # ---- weights ----------------------------------------------------------
    def _serves_packed(self, fmt_name: str) -> bool:
        return self.packed and fmt_name != DENSE_BF16

    def weights_for(self, fmt_name: str):
        """Serving weights at ``fmt_name`` (packed containers by default).
        A miss costs one Slice-and-Scale pass from the anchor (+ nibble
        packing at 4 bits); hits are free."""
        if fmt_name not in self._weights:
            if self._serves_packed(fmt_name):
                w = make_packed_params(self.anchor, target_fmt=fmt_name,
                                       dtype=self.api.cfg.compute_dtype)
            else:
                w = self.dense_weights_for(fmt_name)
            self._weights[fmt_name] = w
            self._fmt_swaps += 1
        return self._weights[fmt_name]

    def dense_weights_for(self, fmt_name: str):
        """Dense weights at ``fmt_name`` — numerically the packed tree's
        (same codes, dequantized ahead of time). Not cached."""
        model = self.anchor
        if fmt_name not in (DENSE_BF16, self.anchor.fmt_name):
            model = convert(self.anchor,
                            get_format(fmt_name, self._block_size))
        return materialize(model, dtype=self.api.cfg.compute_dtype)

    def set_format(self, fmt_name: str):
        self.current_fmt = fmt_name
        return self.weights_for(fmt_name)

    def _api_for(self, fmt_name: str) -> ModelApi:
        return self._packed_api if self._serves_packed(fmt_name) else self.api

    # ---- admission --------------------------------------------------------
    @property
    def prompt_capacity(self) -> int:
        """Longest admissible prompt: ``max_len - 1`` tokens (the first
        generated token's KV is written at position ``plen``)."""
        return self.max_len - 1

    def _prefill_batch(self, prompt: np.ndarray):
        plen = prompt.size
        padded = np.zeros(_bucket_len(plen, self.prompt_capacity), np.int32)
        padded[:plen] = prompt
        return {"tokens": torch.as_tensor(padded[None], device=self.device),
                "lengths": torch.tensor([plen], dtype=torch.int32,
                                        device=self.device)}

    def _finish(self, r: Request, status: RequestStatus,
                error: Optional[str] = None) -> None:
        r.status, r.done, r.error = status, True, error
        self._status_counts[status.value] = \
            self._status_counts.get(status.value, 0) + 1

    def _pop_admissible(self, pending: List[Request]) -> Optional[Request]:
        """Next servable request (FIFO); prompts past the cache capacity end
        FAILED_CAPACITY right here."""
        while pending:
            r = pending.pop(0)
            plen = int(np.asarray(r.prompt).size)
            if plen <= self.prompt_capacity:
                return r
            self._finish(r, RequestStatus.FAILED_CAPACITY,
                         f"prompt ({plen} tokens) exceeds capacity "
                         f"({self.prompt_capacity} = max_len - 1)")
        return None

    # ---- serving loop -----------------------------------------------------
    @torch.no_grad()
    def generate(self, requests: List[Request], greedy: bool = True,
                 fmt_override: Optional[str] = None) -> List[Request]:
        """Serve requests to completion with slot-level continuous
        batching, greedy decoding."""
        if not greedy:
            raise NotImplementedError("sampled decoding is not ported yet; "
                                      "the port decodes greedily")
        b = self.slots
        pending = list(requests)
        active: List[Optional[Request]] = [None] * b
        slot_len = [0] * b              # host mirror of cache_len
        cache = self.api.init_cache(b, self.max_len, device=self.device)
        cache_len = torch.zeros(b, dtype=torch.int32, device=self.device)
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=self.device)
        pinned: Optional[str] = None    # format for this batch's lifetime
        t0 = time.perf_counter()

        while pending or any(a is not None for a in active):
            if pinned is None:          # engine drained: re-pick format
                pinned = self.policy.pick(
                    queue_depth=len(pending),
                    prefill_tokens=sum(np.asarray(r.prompt).size
                                       for r in pending),
                    override=fmt_override)
            weights = self.set_format(pinned)
            api = self._api_for(pinned)

            # ---- admission: one whole prompt per free slot
            for i in range(b):
                if active[i] is not None:
                    continue
                r = self._pop_admissible(pending)
                if r is None:
                    break
                r.status = RequestStatus.RUNNING
                prompt = np.asarray(r.prompt, np.int32)
                t_pf = time.perf_counter()
                logits, cache, new_len = api.prefill_slot(
                    weights, self._prefill_batch(prompt), cache, i)
                cache_len[i] = new_len
                slot_len[i] = prompt.size
                first = int(torch.argmax(logits, -1))
                self._nonfinite_rows += int(not torch.isfinite(logits).all())
                self._prefill_s += time.perf_counter() - t_pf
                self._prefills += 1
                tokens[i, 0] = first
                r.fmt_used = pinned
                r.out_tokens.append(first)
                r.ttft_s = time.perf_counter() - t0
                self._tokens_out += 1
                if len(r.out_tokens) >= r.max_new:
                    self._finish(r, RequestStatus.COMPLETED)
                else:
                    active[i] = r

            if all(a is None for a in active):
                pinned = None           # drained; the next wave re-picks
                continue

            # ---- decode: every slot steps; free slots are masked
            live = [a is not None for a in active]
            mask = torch.tensor(live, dtype=torch.int32, device=self.device)
            t_dec = time.perf_counter()
            logits, cache = api.serve_step(weights, {"tokens": tokens},
                                           cache, cache_len)
            cache_len = cache_len + mask
            nxt = torch.argmax(logits, -1)
            tokens = nxt[:, None].to(torch.int32)
            finite = torch.isfinite(logits).all(-1)
            # one host transfer per tick: the tokens and the finite flags
            drained, finite = torch.stack([nxt, finite.to(nxt.dtype)]) \
                .cpu().numpy()
            self._decode_s += time.perf_counter() - t_dec
            self._ticks += 1
            self._nonfinite_rows += int(sum(
                1 for i in range(b) if live[i] and not finite[i]))
            for i, r in enumerate(active):
                if r is None:
                    continue
                slot_len[i] += 1
                r.out_tokens.append(int(drained[i]))
                self._tokens_out += 1
                if len(r.out_tokens) >= r.max_new or \
                        slot_len[i] >= self.prompt_capacity:
                    self._finish(r, RequestStatus.COMPLETED)
                    active[i] = None    # slot re-admissible next tick
            if all(a is None for a in active):
                pinned = None
        return requests

    # ---- introspection ----------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "formats_cached": sorted(self._weights),
            "weight_bytes": {f: weight_stream_bytes(t)
                             for f, t in self._weights.items()},
            "kernel_launches": dict(mx_matmul.launches),
            "fmt_swaps": self._fmt_swaps,
            "ticks": self._ticks,
            "prefills": self._prefills,
            "tokens_out": self._tokens_out,
            "prefill_s": self._prefill_s,
            "decode_s": self._decode_s,
            "nonfinite_logit_rows": self._nonfinite_rows,
            "current": self.current_fmt,
            "fused": self.fused,
            "device": str(self.device),
            "request_statuses": dict(self._status_counts),
        }
