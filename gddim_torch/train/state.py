"""Training state and optimizer (counterpart of ``gddim_tpu/train/state.py``).

The JAX package's optax chain, with its semantics kept exactly:

- ``clip_by_global_norm(grad_clip)``: gradients scale by grad_clip / norm
  only when norm >= grad_clip (no epsilon, unlike
  ``torch.nn.utils.clip_grad_norm_``); the norm accumulated in f64 and
  rounded to f32, so the CPU and the card agree;
- ``adam(b1, b2, eps)``: bias-corrected moments with the update count
  (the corrections 1 - b**count taken in f32, as optax takes them);
  with ``optim.weight_decay > 0`` ``adamw`` (``state.py:51-57``): the
  decoupled decay ``weight_decay * p`` added to the Adam direction of every
  parameter (optax's ``mask`` is None) before the learning rate scales it,
  so the decay follows the same warmup schedule:
  ``p -= lr_t * (m_hat / (sqrt(v_hat) + eps) + weight_decay * p)``;
- the learning rate ``lr * min(count / warmup, 1)`` is read at the count
  *before* the update, so the first update uses lr = 0;
- an EMA of the parameters at ``ema_rate`` after each update.

The parameters live in the model (``nn.Module``); moments and EMA are dicts
keyed like ``named_parameters()``, updated in place. The Fourier embedding's
frequencies are not trainable (``requires_grad=False``, as ``stop_gradient``
gives them a zero gradient in JAX), so they get neither moments nor EMA.

Under a sharded ``placement`` (FSDP, channel TP: ``parallel/mesh.py``)
each rank holds its shard of every parameter, and the moments and the EMA
are shards of the same layout (ZeRO's point): the update is elementwise,
so it runs on the shards. The global norm sums the squares of every shard
once over the ranks (``Placement.global_norm``), and ``state_dict`` /
``load_state_dict`` gather and split whole tensors, so a sharded run's
checkpoint is the one a single process writes and reads.
"""

from __future__ import annotations

import dataclasses
import sys

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
    weight_decay: float = 0.0  # > 0: adamw
    count: int = 0  # optimizer updates since the optimizer was (re)made
    step: int = 0
    placement: object = None  # parallel.mesh.Placement of a multi-rank run, else None

    _SCALARS = ("count", "step", "lr", "warmup", "beta1", "eps", "grad_clip", "ema_rate",
                "weight_decay")

    def state_dict(self) -> dict:
        """Everything a resumed run needs, as tensors (on their devices) and
        Python numbers, which ``torch.load(weights_only=True)`` reads: the
        model's state_dict, the EMA, Adam's moments, the counters, the
        hyperparameters and the generator's state (a uint8 tensor)."""
        out = {"params": self.model_state_dict(), "ema": self._whole(self.ema),
               "mu": self._whole(self.mu), "nu": self._whole(self.nu),
               "generator": self.generator.get_state()}
        out.update({k: getattr(self, k) for k in self._SCALARS})
        return out

    def _sharded(self) -> bool:
        return self.placement is not None and self.placement.shards_state

    def model_state_dict(self) -> dict:
        """The model's state_dict, whole tensors under a sharded placement
        (a collective: every rank calls it)."""
        if self._sharded():
            return self.placement.full_state_dict(self.model)
        return self.model.state_dict()

    def _whole(self, tensors: dict) -> dict:
        if self._sharded():
            return {k: self.placement.full(self.model, k, t) for k, t in tensors.items()}
        return dict(tensors)

    @torch.no_grad()
    def load_state_dict(self, sd: dict) -> None:
        """Copy a ``state_dict()`` into this state in place, bit for bit; the
        tensors keep their devices. Every key must match. Under a sharded
        placement each rank copies its shard of the whole tensors."""
        if self._sharded():
            self.placement.load_state_dict(self.model, sd["params"])
        else:
            self.model.load_state_dict(sd["params"])
        for name in ("ema", "mu", "nu"):
            mine, theirs = getattr(self, name), sd[name]
            if set(mine) != set(theirs):
                raise KeyError(f"TrainState.{name}: keys differ from the checkpoint's: "
                               f"{sorted(set(mine) ^ set(theirs))[:5]}")
            for k, t in mine.items():
                t.copy_(self.placement.local(self.model, k, theirs[k]) if self._sharded()
                        else theirs[k])
        for k in self._SCALARS:
            # weight_decay: absent from the checkpoints of before adamw (0 there)
            setattr(self, k, type(getattr(self, k))(sd.get(k, 0.0) if k == "weight_decay"
                                                    else sd[k]))
        self.generator.set_state(sd["generator"].cpu())


def trainable(model: nn.Module) -> dict[str, nn.Parameter]:
    return {n: p for n, p in model.named_parameters() if p.requires_grad}


def is_dtensor(t) -> bool:
    dtensor = sys.modules.get("torch.distributed.tensor")  # none made where it is not loaded
    return dtensor is not None and isinstance(t, dtensor.DTensor)


def local_tensor(t):
    """This rank's shard of an FSDP parameter (a DTensor; in-place updates
    of it update the parameter), else ``t`` itself."""
    return t.to_local() if is_dtensor(t) else t


def _zeros(params):
    return {n: torch.zeros_like(local_tensor(p), memory_format=torch.preserve_format)
            for n, p in params.items()}


def create_train_state(config, model: nn.Module, generator: torch.Generator,
                       placement=None) -> TrainState:
    """The state of ``model`` (already placed by ``placement``, if any)."""
    optim = config.optim
    if optim.optimizer != "Adam":
        raise NotImplementedError(f"optimizer {optim.optimizer} is not ported")
    params = trainable(model)
    return TrainState(
        model=model, ema={n: local_tensor(p).detach().clone() for n, p in params.items()},
        mu=_zeros(params), nu=_zeros(params), generator=generator, lr=float(optim.lr),
        warmup=float(optim.warmup), beta1=float(optim.beta1),
        eps=float(optim.eps), grad_clip=float(optim.grad_clip),
        ema_rate=float(config.model.ema_rate), weight_decay=float(optim.weight_decay),
        placement=placement)


def learning_rate(state: TrainState) -> float:
    """The warmup schedule at the current count."""
    if state.warmup > 0:
        return state.lr * min(state.count / state.warmup, 1.0)
    return state.lr


def _bias_correction(beta: float, count: int) -> float:
    """1 - beta ** count in f32, as optax computes it: the f32 power moves
    1 - 0.999 by about 1e-5 of itself from the exact value, and the
    reference's steps carry that."""
    f32 = torch.float32
    return float(1.0 - torch.tensor(beta, dtype=f32) ** torch.tensor(float(count), dtype=f32))


@torch.no_grad()
def apply_gradients(state: TrainState, grads: dict[str, torch.Tensor]) -> dict:
    """Clip, one Adam (weight_decay > 0: AdamW) update of the model's
    parameters and the EMA, in place. grads: keyed like ``trainable(model)``.
    Returns the global norm (before clipping) and the learning rate used."""
    params = trainable(state.model)
    names = list(params)
    p = [local_tensor(params[n]) for n in names]
    g = [local_tensor(grads[n]) for n in names]
    mu = [state.mu[n] for n in names]
    nu = [state.nu[n] for n in names]
    ema = [state.ema[n] for n in names]
    if state._sharded():  # each shard's squares once over the ranks
        norm = state.placement.global_norm(names, g)
    else:
        # summed in f64: an f32 sum over a tensor of a million values strays
        # by ~1e-5 on the CPU (its reduction order), not on the card
        norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(g, 2, dtype=torch.float64))).float()
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
    bc1 = _bias_correction(state.beta1, state.count)
    bc2 = _bias_correction(BETA2, state.count)
    denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
    torch._foreach_add_(denom, state.eps)
    if state.weight_decay > 0:  # optax.adamw: the decay joins the direction lr scales
        step = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        torch._foreach_add_(step, p, alpha=state.weight_decay)
        torch._foreach_add_(p, step, alpha=-lr)
    else:
        torch._foreach_addcdiv_(p, torch._foreach_div(mu, bc1), denom, value=-lr)
    torch._foreach_mul_(ema, state.ema_rate)
    torch._foreach_add_(ema, p, alpha=1.0 - state.ema_rate)
    return {"grad_norm": norm, "lr": lr}


def ema_state_dict(state: TrainState) -> dict[str, torch.Tensor]:
    """The model's state_dict with the EMA in place of the trained
    parameters (whole tensors under a sharded placement: a collective)."""
    sd = state.model_state_dict()
    ema = state._whole(state.ema)
    return {k: ema.get(k, v).detach() for k, v in sd.items()}


@torch.no_grad()
def swap_params_from_ema(state: TrainState) -> None:
    """params <- EMA with a fresh optimizer (moments and count reset), the
    reference's occasional "update from ema" (cld_jax/run_lib.py:203-209)."""
    for n, p in trainable(state.model).items():
        local_tensor(p).copy_(state.ema[n])
    state.mu, state.nu = _zeros(state.mu), _zeros(state.nu)
    state.count = 0
