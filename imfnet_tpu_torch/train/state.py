"""Train state and optimizer construction (``imfnet_tpu.train.state``).

The optimizer mirrors the reference: SGD(momentum=0.8, weight_decay=1e-4)
with per-epoch ExponentialLR(gamma=0.99) (`lib/trainer.py:75-81`,
`config_3dmatch.py:75-87`). ``torch.optim.SGD`` with dampening 0 is the JAX
package's optax chain (grad += wd * param, buf = m * buf + grad,
p -= lr * buf), and the staircase exponential schedule is a ``LambdaLR``
stepped once per optimizer step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from imfnet_tpu_torch.config import Config


@dataclass
class TrainState:
    """What a training step updates in place: the module (parameters and
    running statistics), the optimizer (momentum buffers), the learning
    rate schedule and the count of optimizer steps taken."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: Optional[torch.optim.lr_scheduler.LRScheduler] = None
    step: int = 0


def make_optimizer(params, config: Config, steps_per_epoch: int
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LRScheduler]:
    """(optimizer, scheduler) of the config: SGD with momentum, or Adam, both
    with the weight decay added to the gradient (coupled); the learning
    rate is ``lr * exp_gamma ** (step // steps_per_epoch)``."""
    if config.optimizer == "SGD":
        opt = torch.optim.SGD(params, lr=config.lr, momentum=config.momentum,
                              dampening=0.0, weight_decay=config.weight_decay,
                              nesterov=False)
    elif config.optimizer == "Adam":
        opt = torch.optim.Adam(params, lr=config.lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=config.weight_decay)
    else:
        raise ValueError(f"optimizer {config.optimizer} not supported")
    every = max(steps_per_epoch, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: config.exp_gamma ** (step // every))
    return opt, sched


def create_train_state(model: torch.nn.Module, config: Config,
                       steps_per_epoch: int) -> TrainState:
    opt, sched = make_optimizer(model.parameters(), config, steps_per_epoch)
    return TrainState(model=model, optimizer=opt, scheduler=sched)
