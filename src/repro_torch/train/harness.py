"""The paper's evaluation protocol: counterpart of
``benchmarks/_qat_harness.py``.

Trains a model on the deterministic synthetic corpus under the paper's
protocol shapes (FP fine-tune / single-format QAT / multi-format QAT /
anchor-storage QAT), starting from a shared pretrained base, then measures
a held-out perplexity after PTQ to each evaluation format, or after anchor
-> Slice-and-Scale -> materialize (paper §3.2 'Evaluation': every variant
is converted to the target format before measurement), and a held-out
next-token accuracy (the downstream-task stand-in).

The formulas, floats and defaults are the reference's. What differs:
``HarnessConfig.reduced`` (the reference always takes the reduced config;
``False`` takes the published one), ``device=`` on the entry points that
make tensors (the evaluation runs where the given params live), and the
pretrained base is cached on disk only under a ``cache_dir`` the caller
names (the reference writes ``out/bench_base/`` under the working
directory); that directory takes the reference's checkpoints as they are.
On a CUDA tensor the fake-quant (B7), the anchor's quantization (B6) and
the Slice-and-Scale conversions (B5) run as kernels.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint import io as ckpt_io
from repro_torch.configs import get_config, get_reduced
from repro_torch.core.anchor import convert, make_anchor, materialize
from repro_torch.core.formats import get_format
from repro_torch.core.qat import QATConfig, ptq_pytree
from repro_torch.core.tree import flatten_paths
from repro_torch.data.pipeline import DataConfig, LMDataset, eval_batches
from repro_torch.devices import resolve_device
from repro_torch.interop import params_from_numpy
from repro_torch.models import get_model
from repro_torch.models.common import QuantCtx
from repro_torch.models.transformer import _embed, _lm_head_w, forward_hidden
from repro_torch.optim.adamw import AdamWConfig, init_opt_state
from repro_torch.train.loop import LoopConfig, make_schedule, run_training
from repro_torch.train.state import TrainState, build_train_step

EVAL_MXINT = [f"mxint{b}" for b in range(2, 9)]
EVAL_MXFP = [f"mxfp{b}" for b in range(4, 9)]


@dataclasses.dataclass
class HarnessConfig:
    arch: str = "qwen3-4b"            # reduced family proxy
    train_formats: Sequence[str] = ("mxint2", "mxint4", "mxint6", "mxint8")
    anchor: Optional[str] = None
    block_size: int = 32
    n_examples: int = 128             # paper: 128 WikiText-2 examples
    seq_len: int = 64
    batch: int = 8
    epochs_per_format: int = 1
    lr: float = 5e-4                  # QA-finetune lr (paper sweeps 1e-4..)
    pretrain_steps: int = 600         # paper starts from PRETRAINED models
    pretrain_lr: float = 2e-3
    seed: int = 0
    n_eval_batches: int = 8
    reduced: bool = True              # False: the published config

    def cache_key(self) -> str:
        key = f"{self.arch}_s{self.seed}_p{self.pretrain_steps}"
        return key if self.reduced else key + "_full"

    def model_config(self):
        return get_reduced(self.arch) if self.reduced \
            else get_config(self.arch)


def _build(hc: HarnessConfig, schedule: str):
    cfg = hc.model_config()
    qat = QATConfig(formats=tuple(hc.train_formats), anchor=hc.anchor,
                    block_size=hc.block_size)
    api = get_model(cfg, qat)
    data = LMDataset(DataConfig(vocab=cfg.vocab, seq_len=hc.seq_len,
                                global_batch=hc.batch,
                                n_examples=hc.n_examples, seed=hc.seed))
    total = data.epoch_steps() * hc.epochs_per_format * len(hc.train_formats)
    return cfg, api, data, total


_BASE_CACHE: Dict[tuple, object] = {}


def pretrained_base(hc: HarnessConfig, *, cache_dir: Optional[str] = None,
                    device="cuda"):
    """Pretrain (once, cached in-process and, when ``cache_dir`` is given,
    on disk under ``cache_dir/<cache_key>``) the shared base model — the
    stand-in for the paper's pretrained HF checkpoints."""
    dev = resolve_device(device)
    key = hc.cache_key()
    if (key, dev) in _BASE_CACHE:
        return _BASE_CACHE[(key, dev)]
    cfg = hc.model_config()
    ckdir = os.path.join(cache_dir, key) if cache_dir else None
    if ckdir and ckpt_io.latest_step(ckdir) == hc.pretrain_steps:
        arrays, _ = ckpt_io.restore(ckdir)
        params = params_from_numpy(arrays, cfg, device=dev)
    else:
        data = LMDataset(DataConfig(vocab=cfg.vocab, seq_len=hc.seq_len,
                                    global_batch=16, seed=hc.seed))
        out = run_training(get_model(cfg, None), data,
                           AdamWConfig(lr=hc.pretrain_lr),
                           LoopConfig(total_steps=hc.pretrain_steps,
                                      schedule="fp"),
                           seed=hc.seed, device=dev)
        params = out["state"].params
        if ckdir:
            ckpt_io.save(ckdir, hc.pretrain_steps,
                         dict(flatten_paths(params)), keep_n=1)
    _BASE_CACHE[(key, dev)] = params
    return params


def train_variant(hc: HarnessConfig, schedule: str, *,
                  cache_dir: Optional[str] = None, device="cuda") -> Dict:
    """Fine-tune FROM the pretrained base under the given schedule.

    schedule: 'fp' | 'multiformat' | 'interleaved' | 'single:<pos>'.
    """
    dev = resolve_device(device)
    cfg, api, data, total = _build(hc, schedule)
    base = pretrained_base(hc, cache_dir=cache_dir, device=dev)
    opt_cfg = AdamWConfig(lr=hc.lr)
    sched = make_schedule(schedule, len(hc.train_formats), total)
    step_fn = build_train_step(api, opt_cfg)
    state = TrainState(params=base, opt=init_opt_state(base, opt_cfg),
                       step=0)
    history = []
    for step in range(total):
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
        state, metrics = step_fn(state, batch, int(sched[step]))
        history.append({k: float(v) for k, v in metrics.items()})
    return {"cfg": cfg, "api": api, "params": state.params,
            "history": history}


def _device_of(params) -> torch.device:
    return flatten_paths(params)[0][1].device


def _eval_data(cfg, hc: HarnessConfig, dev):
    batches = eval_batches(DataConfig(vocab=cfg.vocab, seq_len=hc.seq_len,
                                      global_batch=hc.batch, seed=hc.seed),
                           hc.n_eval_batches)
    return [{k: torch.from_numpy(v).to(dev) for k, v in b.items()}
            for b in batches]


def eval_ppl(cfg, api, params, fmt_name: Optional[str],
             hc: HarnessConfig, use_anchor_ss: bool = False) -> float:
    """PTQ params to fmt (direct, or via anchor+SS) and measure eval PPL,
    on the device the params live on."""
    dev = _device_of(params)
    qcfg = QATConfig(formats=("mxint8",), block_size=hc.block_size)
    with torch.no_grad():
        if fmt_name is None:
            p_eval = params
        elif use_anchor_ss:
            anchor_fmt = get_format(hc.anchor or
                                    ("mxint8" if fmt_name.startswith("mxint")
                                     else "mxfp8"), hc.block_size)
            am = make_anchor(params, qcfg, anchor_fmt, device=dev)
            low = convert(am, get_format(fmt_name, hc.block_size))
            p_eval = materialize(low, dtype=torch.float32)
        else:
            p_eval = ptq_pytree(params, qcfg,
                                get_format(fmt_name, hc.block_size))
        losses = [float(api.train_loss(p_eval, b, None)[1]["ce"])
                  for b in _eval_data(cfg, hc, dev)]
    return float(np.exp(np.mean(losses)))


def eval_accuracy(cfg, api, params, fmt_name: Optional[str],
                  hc: HarnessConfig) -> float:
    """Held-out next-token top-1 accuracy (the downstream-task stand-in),
    on the device the params live on."""
    dev = _device_of(params)
    qcfg = QATConfig(formats=("mxint8",), block_size=hc.block_size)
    accs = []
    with torch.no_grad():
        p_eval = params if fmt_name is None else \
            ptq_pytree(params, qcfg, get_format(fmt_name, hc.block_size))
        for b in _eval_data(cfg, hc, dev):
            x = _embed(p_eval, cfg, b["tokens"])
            pos = torch.arange(x.shape[1], device=dev).expand(x.shape[:2])
            hid, _ = forward_hidden(QuantCtx(), p_eval, cfg, x, pos, None,
                                    None, prefill=True)
            logits = hid.to(torch.float32) @ _lm_head_w(p_eval, cfg).to(
                torch.float32)
            pred = torch.argmax(logits, -1)
            accs.append(float(torch.mean(
                (pred == b["labels"].long()).to(torch.float32))))
    return float(np.mean(accs))
