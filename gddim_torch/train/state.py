"""Training state and optimizer (counterpart of ``gddim_tpu/train/state.py``).

The JAX package's optax chain, with its semantics kept exactly:

- ``clip_by_global_norm(grad_clip)``: gradients scale by grad_clip / norm
  only when norm >= grad_clip (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``);
- ``adam(b1, b2, eps)``: bias-corrected moments with the update count;
- the learning rate ``lr * min(count / warmup, 1)`` is read at the count
  *before* the update, so the first update uses lr = 0;
- an EMA of the parameters at ``ema_rate`` after each update.

The parameters live in the model (``nn.Module``); moments and EMA are dicts
keyed like ``named_parameters()``, updated in place. The Fourier embedding's
frequencies are not trainable (``requires_grad=False``, as ``stop_gradient``
gives them a zero gradient in JAX), so they get neither moments nor EMA.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

BETA2 = 0.999  # optax.adam's default; the JAX config does not set it


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    ema: dict[str, torch.Tensor]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]
    generator: torch.Generator  # t, z and dropout masks
    lr: float
    warmup: float
    beta1: float
    eps: float
    grad_clip: float
    ema_rate: float
    count: int = 0  # optimizer updates since the optimizer was (re)made
    step: int = 0

    _SCALARS = ("count", "step", "lr", "warmup", "beta1", "eps", "grad_clip", "ema_rate")

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors (on their devices) and
        Python numbers, which ``torch.load(weights_only=True)`` reads: the
        model's state_dict, the EMA, Adam's moments, the counters, the
        hyperparameters and the generator's state (a uint8 tensor)."""
        out = {"params": self.model.state_dict(), "ema": dict(self.ema), "mu": dict(self.mu),
               "nu": dict(self.nu), "generator": self.generator.get_state()}
        out.update({k: getattr(self, k) for k in self._SCALARS})
        return out

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a ``state_dict()`` into this state in place, bit for bit; the
        tensors keep their devices. Every key must match."""
        self.model.load_state_dict(sd["params"])
        for name in ("ema", "mu", "nu"):
            mine, theirs = getattr(self, name), sd[name]
            if set(mine) != set(theirs):
                raise KeyError(f"TrainState.{name}: keys differ from the checkpoint's: "
                               f"{sorted(set(mine) ^ set(theirs))[:5]}")
            for k, t in mine.items():
                t.copy_(theirs[k])
        for k in self._SCALARS:
            setattr(self, k, type(getattr(self, k))(sd[k]))
        self.generator.set_state(sd["generator"].cpu())


def trainable(model: nn.Module) -> dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def _zeros(params):
    return {n: torch.zeros_like(p, memory_format=torch.preserve_format) for n, p in params.items()}


def create_train_state(config, model: nn.Module, generator: torch.Generator) -> TrainState:
    optim = config.optim
    if optim.optimizer != "Adam":
        raise NotImplementedError(f"optimizer {optim.optimizer} is not ported")
    if float(optim.weight_decay) > 0:
        raise NotImplementedError("weight_decay > 0 (adamw) is not ported")
    params = trainable(model)
    return TrainState(
        model=model, ema={n: p.detach().clone() for n, p in params.items()},
        mu=_zeros(params), nu=_zeros(params), generator=generator, lr=float(optim.lr),
        warmup=float(optim.warmup), beta1=float(optim.beta1),
        eps=float(optim.eps), grad_clip=float(optim.grad_clip),
        ema_rate=float(config.model.ema_rate))


def learning_rate(state: TrainState) -> float:
    """The warmup schedule at the current count."""
    if state.warmup > 0:
        return state.lr * min(state.count / state.warmup, 1.0)
    return state.lr


@torch.no_grad()
def apply_gradients(state: TrainState, grads: dict[str, torch.Tensor]) -> dict:
    """Clip, one Adam update of the model's parameters and the EMA, in place.
    grads: keyed like ``trainable(model)``. Returns the global norm (before
    clipping) and the learning rate used."""
    params = trainable(state.model)
    names = list(params)
    p = [params[n] for n in names]
    g = [grads[n] for n in names]
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    ema = [state.ema[n] for n in names]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
    if state.grad_clip >= 0:
        scale = torch.where(norm < state.grad_clip, torch.ones_like(norm),
                            state.grad_clip / norm)
        g = torch._foreach_mul(g, scale)
    lr = learning_rate(state)
    state.count += 1
    torch._foreach_mul_(mu, state.beta1)
    torch._foreach_add_(mu, g, alpha=1.0 - state.beta1)
    torch._foreach_mul_(nu, BETA2)
    torch._foreach_addcmul_(nu, g, g, value=1.0 - BETA2)
    bc1 = 1.0 - state.beta1 ** state.count
    bc2 = 1.0 - BETA2 ** state.count
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, state.eps)
    torch._foreach_addcdiv_(p, torch._foreach_div(mu, bc1), denom, value=-lr)
    torch._foreach_mul_(ema, state.ema_rate)
    torch._foreach_add_(ema, p, alpha=1.0 - state.ema_rate)
    return {"grad_norm": norm, "lr": lr}


def ema_state_dict(state: TrainState) -> dict[str, torch.Tensor]:
    """The model's state_dict with the EMA in place of the trained parameters."""
    sd = state.model.state_dict()
    return {k: state.ema.get(k, v).detach() for k, v in sd.items()}


@torch.no_grad()
def swap_params_from_ema(state: TrainState) -> None:
    """params <- EMA with a fresh optimizer (moments and count reset), the
    reference's occasional "update from ema" (cld_jax/run_lib.py:203-209)."""
    for n, p in trainable(state.model).items():
        p.copy_(state.ema[n])
    state.mu, state.nu = _zeros(state.mu), _zeros(state.nu)
    state.count = 0
