"""Model construction, the train step and the serving step functions, the
port of the reference's ``launch/steps.py`` for one device (no mesh, no
sharding rules)."""

from __future__ import annotations

from typing import Optional

import torch

from ..checkpoint.store import flatten_with_keys, map_with_keys
from ..configs.base import ArchConfig
from ..models.layers import RuntimeFlags
from ..models.transformer import LanguageModel
from ..optim.adamw import AdamWState, adamw_update, cosine_schedule

__all__ = ["build_model", "build_train_step", "build_prefill_step", "build_decode_step"]


def build_model(cfg: ArchConfig, flags: Optional[RuntimeFlags] = None) -> LanguageModel:
    return LanguageModel(cfg, flags or RuntimeFlags())


def _value_and_grad(model: LanguageModel, params: dict, batch: dict):
    """``(loss, metrics, grads)`` of ``model.loss_fn`` at ``params``, the
    gradients by key (:func:`flatten_with_keys`), by ``torch.autograd``
    through views of the leaves (no copy; ``params`` itself never
    requires a gradient)."""
    live = map_with_keys(lambda _, p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss_fn(live, batch)
    flat = flatten_with_keys(live)
    grads = torch.autograd.grad(loss, list(flat.values()))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(flat, grads)))


def build_train_step(model: LanguageModel, lr: float = 3e-4, total_steps: int = 10000,
                     micro_batches: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, metrics)``:
    fwd + bwd + AdamW, the reference's train step.  ``micro_batches`` > 1
    accumulates the gradients of equal batch slices in a loop (the
    reference scans them): the sum divided by the count, the loss the
    mean, ``ce`` / ``aux`` the last slice's.  The learning rate follows
    ``cosine_schedule(step, lr, warmup=100, total=total_steps)``.  The
    metrics (``loss``, ``ce``, ``aux``, ``grad_norm``) stay tensors on the
    device: the step makes no host sync of its own.  The returned params
    and state are new tensors (:func:`..optim.adamw.adamw_update` is
    functional)."""

    def train_step(params: dict, opt_state: AdamWState, batch: dict):
        if micro_batches > 1:
            grads, loss = {}, 0.0
            for i in range(micro_batches):
                part = {k: v.reshape((micro_batches, v.shape[0] // micro_batches)
                                     + tuple(v.shape[1:]))[i] for k, v in batch.items()}
                l_i, metrics, g = _value_and_grad(model, params, part)
                grads = {k: grads[k] + x if k in grads else x for k, x in g.items()}
                loss = loss + l_i
            grads = {k: x / micro_batches for k, x in grads.items()}
            loss = loss / micro_batches
        else:
            loss, metrics, grads = _value_and_grad(model, params, batch)
        lr_t = cosine_schedule(opt_state.step, lr, warmup=100, total=total_steps)
        new_params, new_state, om = adamw_update(
            map_with_keys(lambda k, _: grads[k], params), opt_state, params, lr_t)
        return new_params, new_state, {"loss": loss, **metrics,
                                       "grad_norm": om["grad_norm"]}

    return train_step


def build_prefill_step(model: LanguageModel, max_seq: int):
    """``step(params, {"tokens": (B, S) int32, optional "frontend": (B, P,
    D)}) -> (logits, cache)``."""

    def prefill_step(params, batch):
        return model.prefill(params, batch["tokens"], max_seq, batch.get("frontend"))

    return prefill_step


def build_decode_step(model: LanguageModel):
    """``step(params, cache, tokens (B, 1)) -> (logits, cache)``, the cache
    updated in place."""

    def decode_step(params, cache, tokens):
        return model.decode_step(params, cache, tokens)

    return decode_step
