"""Optimizers with optax's semantics, as plain tensor code over a parameter list.

Port of ``gloria_tpu.training.optim.make_optimizer``: the reference
builder's Adam, AdamW and SGD, with gradient clipping by global norm and the
skip-on-non-finite guard.  The update follows the optax chain step for step:

1. guard: ``ok = isfinite(norm)``, ``norm`` being the global norm of the
   gradients, which the caller computes once; when not ok the gradients are
   zeroed *before* the chain, so the moments still see the decay term;
2. ``clip_by_global_norm``: ``g / norm * max_norm`` when ``norm >= max_norm``
   (no ``+1e-6``, unlike ``torch.nn.utils.clip_grad_norm_``); after the
   guard the norm is ``where(ok, norm, 0)``;
3. Adam: coupled decay ``g + wd·p``, then the moments (betas 0.5, 0.999,
   eps 1e-8, bias-corrected); AdamW: the moments (betas 0.9, 0.999), then
   ``+ wd·p``; SGD: ``g + wd·p``, then the momentum trace ``g + m·trace``;
4. ``−lr ·``, and the guard zeroes the update when not ok and counts the
   step in ``total_notfinite``.

The guard's decisions stay on the device (``torch.where``), so a step needs
no device→host read.  The epoch-level LR schedulers (:class:`LRScheduler`)
run on the host; the trainer pushes their rate into :class:`OptState` with
:func:`set_learning_rate`.  optax's flattened layout is not ported.

The freeze flags (``freeze_bert``, ``freeze_cnn``,
``train_last_local_image_layer``, ``train_prompt``) are
:func:`trainable_predicate` over parameter names; :func:`freeze_wrap`
gives the optimizer a trainable mask, as ``optax.multi_transform`` with
``set_to_zero`` does in JAX: the chain above (guard, clip, decay, moments)
sees only the trainable parameters and their gradients, its global norm
included, and a frozen parameter is never written.  Callers hand
:meth:`Optimizer.init` and :meth:`Optimizer.update` the lists that
:meth:`Optimizer.select` picks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from ..configs import Config

ADAM_BETAS = {"adam": (0.5, 0.999), "adamw": (0.9, 0.999)}
ADAM_EPS = 1e-8


def global_norm(tensors: list[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ x²) over every element of every tensor (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


@dataclasses.dataclass
class OptState:
    lr: float
    count: int = 0                                   # updates taken, skipped ones included
    mu: list[torch.Tensor] | None = None             # Adam first moments
    nu: list[torch.Tensor] | None = None             # Adam second moments
    trace: list[torch.Tensor] | None = None          # SGD momentum
    total_notfinite: torch.Tensor | None = None      # int32 count of skipped steps


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str                       # "adam", "adamw" or "sgd"
    lr: float
    weight_decay: float = 0.0
    grad_clip: float | None = None
    momentum: float = 0.0           # SGD only
    skip_nonfinite: bool = True
    # freeze_wrap's mask over the model's parameters, in order; None: all train
    trainable: tuple[bool, ...] | None = None

    def select(self, tensors: list) -> list:
        """The entries of ``tensors`` (one per parameter, in the model's
        order) that belong to trainable parameters."""
        if self.trainable is None:
            return list(tensors)
        if len(tensors) != len(self.trainable):
            raise ValueError(f"{len(tensors)} tensors for a mask over {len(self.trainable)} "
                             "parameters")
        return [t for t, keep in zip(tensors, self.trainable) if keep]

    def init(self, params: list[torch.Tensor]) -> OptState:
        """State over ``params``, the trainable ones (:meth:`select`)."""
        state = OptState(lr=self.lr)
        if self.name in ADAM_BETAS:
            state.mu = [torch.zeros_like(p) for p in params]
            state.nu = [torch.zeros_like(p) for p in params]
        elif self.momentum:
            state.trace = [torch.zeros_like(p) for p in params]
        if self.skip_nonfinite:
            device = params[0].device if params else None
            state.total_notfinite = torch.zeros((), dtype=torch.int32, device=device)
        return state

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], state: OptState, params: list[torch.Tensor],
               norm: torch.Tensor) -> list[torch.Tensor]:
        """The updates to add to ``params``; ``state`` moves one step in place.
        ``grads`` and ``params`` are the trainable ones (:meth:`select`),
        ``norm`` is ``global_norm(grads)``."""
        g = list(grads)
        ok = None
        if self.skip_nonfinite:
            ok = torch.isfinite(norm)
            g = [torch.where(ok, x, torch.zeros_like(x)) for x in g]
            norm = torch.where(ok, norm, torch.zeros_like(norm))
        if self.grad_clip:
            small = norm < self.grad_clip
            g = [torch.where(small, x, x / norm * self.grad_clip) for x in g]
        wd = self.weight_decay
        state.count += 1
        if self.name in ADAM_BETAS:
            if self.name == "adam" and wd:
                g = torch._foreach_add(g, params, alpha=wd)
            u = self._adam(g, state)
            if self.name == "adamw" and wd:
                u = torch._foreach_add(u, params, alpha=wd)
        elif self.name == "sgd":
            u = torch._foreach_add(g, params, alpha=wd) if wd else g
            if self.momentum:
                torch._foreach_mul_(state.trace, self.momentum)
                torch._foreach_add_(state.trace, u)
                u = state.trace  # the scaling below makes new tensors
        else:
            raise ValueError(f"unknown optimizer: {self.name}")
        u = torch._foreach_mul(u, -state.lr)
        if ok is not None:
            u = [torch.where(ok, x, torch.zeros_like(x)) for x in u]
            state.total_notfinite += (~ok).to(torch.int32)
        return u

    def _adam(self, g, state: OptState) -> list[torch.Tensor]:
        b1, b2 = ADAM_BETAS[self.name]
        torch._foreach_mul_(state.mu, b1)
        torch._foreach_add_(state.mu, g, alpha=1 - b1)
        torch._foreach_mul_(state.nu, b2)
        torch._foreach_addcmul_(state.nu, g, g, value=1 - b2)
        mu_hat = torch._foreach_div(state.mu, 1 - b1 ** state.count)
        nu_hat = torch._foreach_div(state.nu, 1 - b2 ** state.count)
        denom = torch._foreach_sqrt(nu_hat)
        torch._foreach_add_(denom, ADAM_EPS)
        return torch._foreach_div(mu_hat, denom)


def make_optimizer(cfg: Config, grad_clip: float | None = None) -> Optimizer:
    """``cfg.train.optimizer`` → :class:`Optimizer`; the LR comes from
    ``lightning.trainer.lr`` (else ``train.lr``, else 1e-4)."""
    train = cfg.train or Config()
    opt_cfg = train.optimizer or Config()
    name = (opt_cfg.name or "Adam").lower()
    if name not in ("adam", "adamw", "sgd"):
        raise ValueError(f"unknown optimizer: {opt_cfg.name}")
    trainer = cfg.lightning.trainer if cfg.lightning and cfg.lightning.trainer else Config()
    lr = float(trainer.lr or train.lr or 1e-4)
    return Optimizer(
        name=name, lr=lr, weight_decay=float(opt_cfg.weight_decay or 0.0),
        grad_clip=float(grad_clip) if grad_clip else None,
        momentum=float(cfg.momentum or opt_cfg.momentum or 0.0),
        skip_nonfinite=(train.skip_nonfinite_grads
                        if train.skip_nonfinite_grads is not None else True))


def set_learning_rate(state: OptState, lr: float) -> OptState:
    state.lr = float(lr)
    return state


def get_learning_rate(state: OptState) -> float:
    return state.lr


# ---------------------------------------------------------------------------
# Freezing: the reference's freeze flags on parameter names
# ---------------------------------------------------------------------------

IMAGE_BACKBONE = "img_encoder.model."   # the JAX package's img_encoder/backbone
TEXT_BERT = "text_encoder.model."       # its text_encoder/bert


def trainable_predicate(cfg: Config) -> Callable[[str], bool]:
    """The freeze flags as a predicate on the port's parameter names (JAX's
    ``trainable_predicate`` on its paths).  ``train_last_local_image_layer``
    or ``train_prompt`` trains only the image backbone's layer3 or BERT's
    embeddings; otherwise ``freeze_bert`` and ``freeze_cnn`` freeze BERT or
    the image backbone (``img_encoder.model.*``: a GLoRIA's, or a
    ``PretrainedImageClassifier``'s; the U-Net's ``backbone.*`` is not
    matched, as in JAX)."""
    m = cfg.model or Config()
    if m.train_last_local_image_layer or m.train_prompt:
        def pred(name: str) -> bool:
            if m.train_last_local_image_layer and f"{IMAGE_BACKBONE}layer3." in name:
                return True
            return bool(m.train_prompt and TEXT_BERT in name and "embeddings" in name)
        return pred

    freeze_bert = bool(m.text and m.text.freeze_bert)
    freeze_cnn = bool(m.vision and m.vision.freeze_cnn)

    def pred(name: str) -> bool:
        if freeze_bert and name.startswith(TEXT_BERT):
            return False
        return not (freeze_cnn and name.startswith(IMAGE_BACKBONE))

    return pred


def partition_trainable(model: torch.nn.Module, trainable_fn: Callable[[str], bool]) -> dict:
    """``{parameter name: "trainable" | "frozen"}`` in ``named_parameters``' order."""
    return {name: "trainable" if trainable_fn(name) else "frozen"
            for name, _ in model.named_parameters()}


def freeze_wrap(optimizer: Optimizer, labels: dict) -> Optimizer:
    """``optimizer`` with ``labels``' frozen parameters masked out."""
    return dataclasses.replace(
        optimizer, trainable=tuple(label == "trainable" for label in labels.values()))


# ---------------------------------------------------------------------------
# Schedulers (epoch-keyed multipliers; plateau is metric-driven)
# ---------------------------------------------------------------------------

def warmup_lambda(epoch: int) -> float:
    """The reference builder's warm-up multiplier of epoch ``epoch``."""
    if epoch <= 3:
        return 0.001 + epoch * 0.003
    if epoch >= 22:
        return 0.01 * (1 - epoch / 200.0) ** 0.9
    return 0.01


@dataclasses.dataclass
class LRScheduler:
    """Host-side LR controller (``gloria_tpu.training.optim.LRScheduler``):
    ``step(metric)`` once per epoch, then push ``current_lr`` into the
    optimizer state with :func:`set_learning_rate`."""

    name: str
    base_lr: float
    factor: float = 0.5
    patience: int = 5
    t_max: int = 10
    gamma: float = 0.8
    mode: str = "min"
    # state
    count: int = 0
    best: float = math.inf
    bad_epochs: int = 0
    current_lr: float = 0.0

    def __post_init__(self):
        self.current_lr = self.base_lr if self.name != "warmup" else self.base_lr * warmup_lambda(0)
        if self.mode == "max":
            self.best = -math.inf

    def step(self, metric: float | None = None) -> float:
        self.count += 1
        e = self.count
        if self.name == "warmup":
            self.current_lr = self.base_lr * warmup_lambda(e)
        elif self.name == "cos":
            self.current_lr = self.base_lr * (1 + math.cos(math.pi * e / self.t_max)) / 2
        elif self.name == "step":
            self.current_lr = self.base_lr * (self.gamma ** e)
        elif self.name == "plateau":
            if metric is not None:
                improved = metric < self.best if self.mode == "min" else metric > self.best
                if improved:
                    self.best = metric
                    self.bad_epochs = 0
                else:
                    self.bad_epochs += 1
                    if self.bad_epochs > self.patience:
                        self.current_lr *= self.factor
                        self.bad_epochs = 0
        elif self.name in (None, "none", "const"):
            pass
        else:
            raise ValueError(f"unknown scheduler: {self.name}")
        return self.current_lr

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in ("count", "best", "bad_epochs", "current_lr")}

    def load_state_dict(self, d: dict) -> None:
        for k, v in d.items():
            setattr(self, k, v)


def make_scheduler(cfg: Config) -> LRScheduler:
    """``train.scheduler.name`` (none when absent) at the optimizer's LR."""
    train = cfg.train or Config()
    sch = train.scheduler or Config()
    trainer = cfg.lightning.trainer if cfg.lightning and cfg.lightning.trainer else Config()
    return LRScheduler(name=(sch.name or "none"), base_lr=float(trainer.lr or train.lr or 1e-4))
