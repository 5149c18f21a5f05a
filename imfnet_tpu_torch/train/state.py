"""Train state and optimizer construction (``imfnet_tpu.train.state``).

The optimizer mirrors the reference: SGD(momentum=0.8, weight_decay=1e-4)
with per-epoch ExponentialLR(gamma=0.99) (`lib/trainer.py:75-81`,
`config_3dmatch.py:75-87`). ``torch.optim.SGD`` with dampening 0 is the JAX
package's optax chain (grad += wd * param, buf = m * buf + grad,
p -= lr * buf), and the staircase exponential schedule is a ``LambdaLR``
stepped once per optimizer step.

On the card the optimizer is capture-safe, so that a CUDA graph of the
training step (``train.step.make_graphed_train_step``) holds its update:
the learning rate is a device tensor that the ``LambdaLR`` fills in place
(from a float base, so a schedule step reads nothing back), and the update
is torch's fused SGD or Adam, which takes the rate from that tensor. A
float rate would be baked into the graph, and the unfused update reads a
tensor rate back to the host. On the CPU the eager optimizer, float rate
and all, stays.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

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


def make_optimizer(params, config: Config, steps_per_epoch: int,
                   capturable: Optional[bool] = None
                   ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LRScheduler]:
    """(optimizer, scheduler) of the config: SGD with momentum, or Adam, both
    with the weight decay added to the gradient (coupled); the learning
    rate is ``lr * exp_gamma ** (step // steps_per_epoch)``.

    ``capturable`` (default: the parameters are on the card) makes the rate
    a tensor on the parameters' device and the update torch's fused one,
    which a CUDA graph can hold."""
    params = list(params)
    if capturable is None:
        capturable = bool(params) and params[0].device.type == "cuda"
    lr: Any = config.lr
    kw: Dict[str, Any] = {}
    if capturable:
        lr = torch.tensor(config.lr, dtype=torch.float32, device=params[0].device)
        kw = dict(fused=True)
    if config.optimizer == "SGD":
        opt = torch.optim.SGD(params, lr=lr, momentum=config.momentum,
                              dampening=0.0, weight_decay=config.weight_decay,
                              nesterov=False, **kw)
    elif config.optimizer == "Adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               weight_decay=config.weight_decay, **kw)
    else:
        raise ValueError(f"optimizer {config.optimizer} not supported")
    for group in opt.param_groups:
        # the schedule's base as a float: a step fills a tensor rate from it
        # without reading the tensor back
        group["initial_lr"] = config.lr
    every = max(steps_per_epoch, 1)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda step: config.exp_gamma ** (step // every))
    return opt, sched


# what a loaded optimizer state keeps of the live optimizer: how it updates
_LIVE_KEYS = ("fused", "foreach", "capturable")


def load_optimizer_state(optimizer: torch.optim.Optimizer, sd: Dict[str, Any]) -> None:
    """``optimizer.load_state_dict(sd)`` that keeps the live optimizer's
    update (fused or not) and its rate's type: a tensor rate stays the same
    tensor, filled with the saved value, so that a CUDA graph that holds it
    goes on reading it, and a state saved on the CPU resumes on the card
    (and the other way round)."""
    live = optimizer.param_groups
    groups = []
    for g, saved in zip(live, sd["param_groups"]):
        saved = dict(saved, **{k: g[k] for k in _LIVE_KEYS if k in g})
        saved["lr"] = float(saved["lr"])
        if "initial_lr" in saved:
            saved["initial_lr"] = float(saved["initial_lr"])
        groups.append(saved)
    rates = [g["lr"] for g in live]
    optimizer.load_state_dict(dict(sd, param_groups=groups))
    for g, rate in zip(optimizer.param_groups, rates):
        if isinstance(rate, torch.Tensor):
            rate.fill_(g["lr"])
            g["lr"] = rate


def create_train_state(model: torch.nn.Module, config: Config,
                       steps_per_epoch: int) -> TrainState:
    opt, sched = make_optimizer(model.parameters(), config, steps_per_epoch)
    return TrainState(model=model, optimizer=opt, scheduler=sched)
