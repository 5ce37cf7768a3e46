"""SFT trainer: the train state, the optimizer and one train step
(reference: seedx_tpu/train/trainer.py).

Only the trainable leaves (``train/partition.py``) become fp32
``nn.Parameter``s in the model (``models/layers.set_trainable_``); the
frozen 13B and the ViT stay bf16 buffers, with no gradient and no
optimizer state.  The optimizer is the JAX package's optax chain written
out: ``clip_by_global_norm(max_grad_norm)`` (no epsilon on the norm,
unlike ``torch.nn.utils.clip_grad_norm_``) then AdamW with decoupled decay
on every trainable leaf, ``eps`` outside the square root, bias-corrected
moments, and the lr of update t (from 0) ``schedule(t)``.  Gradient
accumulation averages the grads and losses of ``accum`` micro-batches
(reference trainer.py:113-153).

Hyperparameter defaults follow scripts/train_seed_x_sft_comp_gen.sh:19-35
(lr 1e-4, wd 0.05, betas (0.9, 0.98), eps 1e-6, cosine min-lr 0.05, warmup
500, 20k steps, grad clip 1.0).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterable, Mapping, Optional, Tuple

import torch
from torch import nn

from seedx_tpu_torch.models.layers import set_trainable_
from seedx_tpu_torch.train.partition import (SEED_X_TRAINABLE_PATTERNS,
                                             path_labels)
from seedx_tpu_torch.train.schedule import Schedule, get_schedule

LOSS_KEYS = ("total_loss", "lm_loss", "rec_loss")
_BATCH_KEYS = ("input_ids", "attention_mask", "labels", "image_embeds",
               "embeds_gen_mask", "embeds_cmp_mask", "ids_gen_mask",
               "ids_cmp_mask", "patch_positions")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-4
    weight_decay: float = 0.05
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    adam_epsilon: float = 1e-6
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "cosine"
    warmup_steps: int = 500
    max_steps: int = 20000
    min_lr_ratio: float = 0.05
    gradient_accumulation_steps: int = 1
    trainable_patterns: Tuple[str, ...] = SEED_X_TRAINABLE_PATTERNS


@dataclasses.dataclass
class TrainState:
    """The step count, the trainable leaves (the model's own parameters)
    and the Adam moments of each ({"mu": {...}, "nu": {...}})."""

    step: int
    params: Dict[str, nn.Parameter]
    opt_state: Dict[str, Dict[str, torch.Tensor]]

    def state_dict(self) -> Dict:
        """What a checkpoint holds: the step, the trainable leaves and the
        optimizer state (views of the live tensors)."""
        return {"step": self.step,
                "trainable": {n: p.detach() for n, p in self.params.items()},
                "opt_state": self.opt_state}

    @torch.no_grad()
    def load_state_dict(self, state: Mapping) -> None:
        if set(state["trainable"]) != set(self.params):
            raise ValueError("checkpoint's trainable leaves differ from the "
                             "model's")
        self.step = int(state["step"])
        for n, p in self.params.items():
            p.copy_(state["trainable"][n])
            for k in ("mu", "nu"):
                self.opt_state[k][n].copy_(state["opt_state"][k][n])


def make_schedule(cfg: TrainConfig) -> Schedule:
    return get_schedule(cfg.lr_scheduler_type, cfg.learning_rate,
                        cfg.warmup_steps, cfg.max_steps, cfg.min_lr_ratio)


def create_train_state(model: nn.Module, cfg: TrainConfig) -> TrainState:
    """Mark the leaves matching ``cfg.trainable_patterns`` trainable (fp32
    parameters, in place) and give each zero Adam moments; every other
    leaf stays a frozen buffer."""
    labels = path_labels(model.state_dict().keys(), cfg.trainable_patterns)
    names = set_trainable_(model, [n for n, lab in labels.items()
                                   if lab == "trainable"])
    params = {n: model.get_parameter(n) for n in names}
    opt_state = {k: {n: torch.zeros_like(p) for n, p in params.items()}
                 for k in ("mu", "nu")}
    return TrainState(step=0, params=params, opt_state=opt_state)


def global_norm(tensors: Iterable[torch.Tensor], splits=None,
                groups=None) -> torch.Tensor:
    """sqrt of the sum of squares over every element (optax.global_norm).
    On a mesh (``groups``) the tensors are this rank's shards and
    ``splits`` gives, per tensor, the mesh axes that split it: each
    tensor's sum of squares is summed over those axes, and a replicated
    tensor counts once."""
    sq = torch.stack([t.float().square().sum() for t in tensors])
    if groups is not None:
        for axis in ("fsdp", "tensor"):
            idx = [i for i, axes in enumerate(splits) if axis in axes]
            if idx:
                part = groups.all_reduce(sq[idx].contiguous(), axis)
                sq = sq.index_copy(0, torch.tensor(idx, device=sq.device),
                                   part)
    return torch.sqrt(sq.sum())


def mesh_groups(model: nn.Module):
    """The ``MeshGroups`` of a model placed on a mesh
    (``parallel/mesh.place_params``), else None."""
    return next((vars(m)["_par"] for m in model.modules()
                 if "_par" in vars(m)), None)


@torch.no_grad()
def sync_grads(grads: Mapping[str, torch.Tensor], splits, groups) -> None:
    """Sum each rank's gradients over the batch axes, in place: over
    ``data``, and over ``fsdp`` for a leaf ``fsdp`` does not split (the
    gather's backward already reduce-scattered the others).  A leaf's
    ``tensor`` peers hold the same rows and so the same gradient."""
    for name, g in grads.items():
        for axis in (("data",) if "fsdp" in splits[name]
                     else ("fsdp", "data")):
            groups.all_reduce(g, axis)


@torch.no_grad()
def apply_updates(state: TrainState, grads: Mapping[str, torch.Tensor],
                  cfg: TrainConfig, schedule: Schedule, splits=None,
                  groups=None) -> torch.Tensor:
    """One optimizer update in place (optax ``chain(clip_by_global_norm,
    adamw)`` then ``apply_updates``); increments ``state.step``.  Returns
    the global norm of ``grads`` before the clip.  On a mesh each rank
    updates its shards, clipped by the norm of the logical leaves
    (``global_norm``)."""
    norm = global_norm(grads.values(),
                       None if splits is None else
                       [splits[n] for n in grads], groups)
    clip = norm >= cfg.max_grad_norm
    count = state.step + 1
    b1, b2 = cfg.adam_beta1, cfg.adam_beta2
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    lr = schedule(state.step)
    for name, p in state.params.items():
        g = grads[name]
        g = torch.where(clip, g / norm * cfg.max_grad_norm, g)
        mu, nu = state.opt_state["mu"][name], state.opt_state["nu"][name]
        mu.mul_(b1).add_(g, alpha=1.0 - b1)
        nu.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.adam_epsilon)
        p.sub_(lr * (u + cfg.weight_decay * p))
    state.step += 1
    return norm


def micro_batches(batch: Mapping[str, torch.Tensor], accum: int):
    """The ``accum`` micro-batches of a batch stacked on a leading axis
    (or the batch itself when ``accum`` is 1)."""
    if accum == 1:
        return [batch]
    return [{k: v[i] for k, v in batch.items()} for i in range(accum)]


def compute_grads(model: nn.Module, params: Mapping[str, nn.Parameter],
                  batch: Mapping[str, torch.Tensor], accum: int = 1,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """(grads, losses) of ``total_loss`` averaged over the ``accum``
    micro-batches of ``batch``; a leaf no loss reaches gets zeros.  The
    micro-batches draw their dropout masks from ``generator`` in turn."""
    for p in params.values():
        p.grad = None
    sums = {k: torch.zeros((), dtype=torch.float32) for k in LOSS_KEYS}
    groups = mesh_groups(model)
    for mb in micro_batches(batch, accum):
        out = model(**{k: mb.get(k) for k in _BATCH_KEYS},
                    generator=generator)
        out["total_loss"].backward()
        sums = {k: sums[k].to(out[k].device) + out[k].detach()
                for k in LOSS_KEYS}
    grads = {}
    for n, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        grads[n] = g / accum if accum > 1 else g
        p.grad = None
    if groups is not None:
        # each rank's losses are its share of the global means
        for v in sums.values():
            groups.batch_sum(v)
    return grads, {k: v / accum for k, v in sums.items()}


def sync_time(device: torch.device) -> float:
    """``time.perf_counter()`` after the device's queued work is done."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def make_train_step(model: nn.Module, cfg: TrainConfig
                    ) -> Callable[..., Dict[str, float]]:
    """Returns ``train_step(state, batch, generator=None) -> metrics``,
    which updates ``state`` (and the model's trainable leaves) in place.
    ``batch`` holds the reference collator's keys (input_ids,
    attention_mask, labels, image_embeds, embeds_gen_mask,
    embeds_cmp_mask, ids_gen_mask, ids_cmp_mask, patch_positions) as
    tensors on the model's device, with a leading micro-batch axis when
    ``cfg.gradient_accumulation_steps`` > 1.  Metrics: the three losses,
    ``grad_norm`` (before the clip), ``lr``, and the device-synchronised
    milliseconds of forward + backward (``fwd_bwd_ms``, the gradients'
    sum over the batch axes included) and of the optimizer (``opt_ms``).

    On a mesh (``model`` placed by ``parallel/mesh.place_params``) each
    rank passes its rows of the global batch; the losses are global means
    (``llama.causal_lm_loss``), the gradients are summed over the batch
    axes (``sync_grads``), the clip takes the norm of the logical leaves,
    AdamW updates each rank's shards, and the metrics are the global ones
    on every rank."""
    schedule = make_schedule(cfg)
    accum = cfg.gradient_accumulation_steps
    groups = mesh_groups(model)

    def train_step(state: TrainState, batch: Mapping[str, torch.Tensor],
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, float]:
        device = batch["input_ids"].device
        t0 = sync_time(device)
        grads, losses = compute_grads(model, state.params, batch, accum,
                                      generator)
        splits = None
        if groups is not None:
            from seedx_tpu_torch.parallel.mesh import leaf_layout, split_axes

            splits = {n: split_axes(leaf_layout(model, n)) for n in grads}
            sync_grads(grads, splits, groups)
        t1 = sync_time(device)
        lr = schedule(state.step)
        norm = apply_updates(state, grads, cfg, schedule, splits, groups)
        t2 = sync_time(device)
        metrics = {k: float(v) for k, v in losses.items()}
        metrics.update(grad_norm=float(norm), lr=lr,
                       fwd_bwd_ms=(t1 - t0) * 1e3, opt_ms=(t2 - t1) * 1e3)
        return metrics

    return train_step
