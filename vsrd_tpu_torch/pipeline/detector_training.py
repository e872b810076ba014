"""Detector training on the pseudo-labels, data-parallel over processes.

Counterpart of ``vsrd_tpu/pipeline/detector_training.py``, whose step is a
``shard_map`` over a ``dp`` mesh with ``pmean``-averaged gradients, loss and
scalars. Here each process holds one shard of the global batch; with more
than one process the model is wrapped in ``DistributedDataParallel`` (whose
backward averages the gradients over processes, as ``pmean`` does), the
loss's matched-box count is averaged over processes before it normalizes
the box losses (``detr_loss(distributed=True)``), and the loss and scalars
are averaged for the log. With one process the step is a plain step. The
process group comes from ``parallel/distributed.py``.

The step follows the detector class's ``TrainingRecipe``
(``models/detr3d.py``): the JAX package's step for ``DETR3D`` and
``DeformableDETR3D``; for ``PublishedDETR3D`` DETR's (AdamW at 1e-4 and
1e-5 for the trained backbone, the frozen parameters left out, the global
gradient norm clipped to 0.1, the loss on all six decoder levels with GIoU
and the no-object weight 0.1). The step's
stages are named (``utils/spans.py``, ``det.*``) and it waits on the
device nowhere: the loss and its terms come back as device tensors.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models import detr3d
from ..parallel import distributed as parallel
from ..utils import spans

WEIGHT_DECAY = 1e-4     # optax.adamw's default and DETR's, on every parameter


def make_optimizer(model: nn.Module, learning_rate: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``: betas (0.9, 0.999), eps 1e-8 and
    decoupled weight decay 1e-4 (torch's default decay is 1e-2), over the
    parameters that take a gradient; where the model's recipe has a
    ``backbone_lr``, the trained backbone's parameters are a second group
    at that rate, as DETR's."""
    backbone_lr = model.recipe.backbone_lr
    trained = [(name, p) for name, p in model.named_parameters() if p.requires_grad]
    if backbone_lr is None:
        groups = [{"params": [p for _, p in trained]}]
    else:
        groups = [{"params": [p for name, p in trained if not name.startswith("backbone.")]},
                  {"params": [p for name, p in trained if name.startswith("backbone.")],
                   "lr": backbone_lr}]
    return torch.optim.AdamW(groups, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=WEIGHT_DECAY)


def create_train_state(model: nn.Module, learning_rate: float = 1e-4,
                       device: torch.device | str = "cuda"):
    """``(model, optimizer)``: the model on ``device``, wrapped in
    ``DistributedDataParallel`` when the process group has more than one
    process (rank 0's parameters are broadcast), and its AdamW."""
    model = model.to(device)
    if parallel.process_count() > 1:
        device = torch.device(device)
        model = nn.parallel.DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            find_unused_parameters=True)
    return model, make_optimizer(unwrap(model), learning_rate)


def unwrap(model: nn.Module) -> nn.Module:
    """The detector inside a ``DistributedDataParallel`` wrapper."""
    return model.module if isinstance(model, nn.parallel.DistributedDataParallel) else model


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer, num_classes: int = 1):
    """``step(batch) -> (loss, scalars)`` on this process's shard of the
    global batch (``images``, ``intrinsics``, ``labels``, ``boxes_2d``,
    ``boxes_3d``, ``valid``); loss and scalars are the means over
    processes. Every trained parameter gets a gradient, zero where the loss
    does not reach it (the confidence head), so that AdamW decays it as
    optax does."""
    distributed = parallel.process_count() > 1
    recipe = unwrap(model).recipe
    params = [p for group in optimizer.param_groups for p in group["params"]]

    def step(batch):
        with spans.span(spans.DETECTOR_STEP):
            model.train()
            outputs = model(batch["images"], batch["intrinsics"], aux_outputs=recipe.aux_loss)
            loss, scalars = detr3d.detr_loss(
                outputs, batch["labels"], batch["boxes_2d"], batch["boxes_3d"], batch["valid"],
                num_classes=num_classes, distributed=distributed, giou=recipe.giou,
                no_object_weight=recipe.no_object_weight)
            with spans.span(spans.DETECTOR_BACKWARD):
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                optimizer.zero_grad(set_to_none=False)
                loss.backward()
            with spans.span(spans.DETECTOR_OPTIM):
                if recipe.max_norm is not None:
                    nn.utils.clip_grad_norm_(params, recipe.max_norm)
                optimizer.step()
            with spans.span(spans.DETECTOR_LOSS):
                report = torch.stack([loss.detach()] + [v.detach() for v in scalars.values()])
                if distributed:
                    dist.all_reduce(report)
                    report = report / dist.get_world_size()
        return report[0], dict(zip(scalars, report[1:]))

    return step
