"""Training and eval steps (counterpart of ``gddim_tpu/train/step.py``).

``train_step(state, batches)`` takes one optimizer step per entry of the
batches' leading ``n_jitted_steps`` axis, as the JAX step scans them inside
one jit; PyTorch runs eagerly, so here it is a loop. ``eval_step`` is the
loss on the EMA parameters.

Under ``state.placement`` (a multi-rank run) ``batches`` holds this rank's
rows of the global batch: the step draws t, z and the dropout masks of the
global batch and keeps its rows (``Placement.rows``), averages the
gradients over the batch's ranks where FSDP2 does not
(``Placement.reduce_gradients``), and reports the loss's mean over the
ranks. With no placement it is the one-process step it always was.
"""

from __future__ import annotations

import torch
from torch.func import functional_call

from gddim_torch.train.state import TrainState, apply_gradients, trainable


def make_train_step(loss_fn):
    """train_step(state, batches) -> {'loss': mean loss, 'grad_norm': last}.
    batches: (n_jitted_steps, B, H, W, C) scaled images on the model's device."""

    def train_step(state: TrainState, batches: torch.Tensor) -> dict:
        params = trainable(state.model)
        placement = state.placement
        losses, info = [], {}
        for images in batches:
            for p in params.values():
                p.grad = None
            generator = (state.generator if placement is None
                         else placement.rows(state.generator, images.shape[0]))
            loss = loss_fn(state.model, images, generator)
            loss.backward()
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            if placement is not None:
                placement.reduce_gradients(list(grads.values()))
            info = apply_gradients(state, grads)
            state.step += 1
            losses.append(loss.detach())
        for p in params.values():
            p.grad = None
        loss = torch.stack(losses).mean()
        if placement is not None:
            loss = placement.mean(loss)
        return {"loss": loss, "grad_norm": info.get("grad_norm")}

    return train_step


def make_eval_step(loss_fn):
    """eval_step(state, images, generator) -> loss on the EMA parameters
    (reference losses.py:179-181); ``loss_fn`` is an eval (train=False) loss."""

    def eval_step(state: TrainState, images: torch.Tensor, generator: torch.Generator):
        def ema_model(*args, **kwargs):
            return functional_call(state.model, state.ema, args, kwargs)

        with torch.no_grad():
            return loss_fn(ema_model, images, generator)

    return eval_step
