"""Training and serving step functions (PyTorch counterpart of
repro.train.steps).

The train step is the reference's: the token-mean cross entropy plus 0.01 x
the MoE load-balance loss, its gradient by autograd, then AdamW. The
parameters and the moments are updated in place (optim/adam.py).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model_zoo as zoo
from repro_torch.optim.adam import AdamConfig, AdamState, adam_init, adam_update
from repro_torch.train.options import PerfOptions, resolve as resolve_options


def softmax_xent(logits, labels, sharded: bool = False):
    """Token-mean cross entropy, fp32 accumulation, bf16 logits in.

    sharded=True is the reference's vocab-sharded formula: the label logit
    by an iota-compare-reduce and logsumexp written out with a stopped
    maximum. On one device it constrains no layout; it keeps its formula, so
    the two forms agree as they do in the reference.
    """
    lf = logits.float()
    labels = labels.long()
    if sharded:
        m = torch.amax(lf, dim=-1, keepdim=True).detach()
        lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
        vocab_iota = torch.arange(lf.shape[-1], device=lf.device)
        gold = torch.sum(torch.where(vocab_iota == labels[..., None], lf, 0.0), dim=-1)
        return torch.mean(lse - gold)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None])[..., 0]
    return torch.mean(lse - gold)


def make_train_step(cfg: ModelConfig, ocfg: AdamConfig, options: Optional[PerfOptions] = None):
    """(model, opt_state, batch) -> (model, opt_state, metrics); the model's
    parameters and the moments are updated in place. metrics: loss, aux_loss,
    grad_norm, lr (device scalars)."""
    opts = resolve_options(options)

    def train_step(model, opt_state: AdamState, batch):
        params = [p for _, p in model.named_parameters()]
        with torch.enable_grad():
            logits, aux = zoo.apply_train(cfg, model, batch, options=opts)
            loss = softmax_xent(logits, batch["labels"], sharded=opts.sharded_loss)
            del logits
            grads = torch.autograd.grad(loss + 0.01 * aux, params, materialize_grads=True)
        names = [n for n, _ in model.named_parameters()]
        model, new_opt, om = adam_update(ocfg, model, dict(zip(names, grads)), opt_state)
        metrics = {"loss": loss.detach(), "aux_loss": aux.detach(), **om}
        return model, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, options: Optional[PerfOptions] = None):
    opts = resolve_options(options)

    def prefill_step(params, batch):
        return zoo.apply_prefill(cfg, params, batch, options=opts)

    return prefill_step


def make_decode_step(cfg: ModelConfig, options: Optional[PerfOptions] = None):
    opts = resolve_options(options)

    def decode_step(params, token, caches, cache_len):
        logits, new_caches = zoo.apply_decode(cfg, params, token, caches, cache_len, options=opts)
        return logits, new_caches, cache_len + 1

    return decode_step


def init_train_state(cfg: ModelConfig, ocfg: AdamConfig, seed: int = 0, *, device=None):
    """(model, opt_state): `zoo.init_params(cfg, seed, device=device)` (None:
    the card) and zero moments beside it."""
    params = zoo.init_params(cfg, seed, device=device)
    return params, adam_init(ocfg, params)
