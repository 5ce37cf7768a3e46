"""SFT training loop and CLI (reference: seedx_tpu/train/train_sft.py;
src/train/train_seed_x_sft.py:124-343).

Batches (numpy, the keys of ``data/pipeline.collate_anyres``) -> the
frozen ViT encodes the image tiles under ``torch.no_grad()`` (not
``inference_mode``: the embeddings are saved by the resampler's backward)
-> one train step of the agent -> metrics (``metrics.jsonl``, tensorboard)
every ``log_steps`` -> a checkpoint every ``save_steps`` and at the end.
With ``resume`` the loop restores the latest checkpoint and fast-forwards
the data stream by ``step * accum`` batches, so it trains on exactly the
batches it would have seen; each step's dropout generator is seeded from
(``seed``, step), so a resumed run equals an uninterrupted one.  With
gradient accumulation, ``accum`` consecutive batches are stacked and the
ViT encodes their tiles in one pass.  Runs on the card unless the caller
passes ``device="cpu"``.

``main`` is the JAX package's CLI, flag for flag (reference:
train_seed_x_sft.py:32-75): the transform, tokenizer, visual encoder,
agent and dataset come from the repo's YAML object graphs (``configs/``,
``seedx_tpu.`` read as ``seedx_tpu_torch.``), the datasets stream the
files on disk (``data/datasets.py``), and the run goes to ``train_loop``.
``--device`` (default ``cuda``) is the port's own.  ``--parallel`` (a
``configs/parallel/*.yaml`` mesh layout) trains on a mesh, one process a
card under torchrun's environment (``parallel/distributed``): the agent
and the ViT keep their shards (``parallel/mesh.place_params``: FSDP over
``fsdp``, heads / MLP columns / vocab over ``tensor``), each rank reads
the files of its coordinate on the batch axes (data x fsdp; its
``tensor`` peers read the same), and the losses, gradients and metrics
are the global batch's (``train/trainer.py``).  Checkpoints hold whole
leaves and restore onto any layout (``train/checkpoints.py``).

    torchrun --nproc_per_node 4 -m seedx_tpu_torch.train.train_sft \\
        ... --parallel configs/parallel/fsdp_tensor.yaml

    python -m seedx_tpu_torch.train.train_sft \
        --image_transform configs/processer/qwen_448_transform.yaml \
        --tokenizer configs/tokenizer/clm_llama_tokenizer_224loc_anyres.yaml \
        --visual_encoder configs/visual_encoder/qwen_vitg_448.yaml \
        --agent_model configs/clm_models/agent_seed_x.yaml \
        --train_dataset configs/data/sft_comprehension_gen.yaml
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import os
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from seedx_tpu_torch import config as config_lib
from seedx_tpu_torch.data.pipeline import ResumableIterator
from seedx_tpu_torch.parallel.distributed import maybe_initialize
from seedx_tpu_torch.train.checkpoints import (CheckpointManager,
                                               restore_train_state,
                                               save_train_state)
from seedx_tpu_torch.train.trainer import (TrainConfig, TrainState,
                                           create_train_state,
                                           make_train_step, sync_time)
from seedx_tpu_torch.utils.trackers import MetricWriters

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class RunConfig:
    """The JAX RunConfig's fields, less ``data_seed_per_epoch``, which no
    loop of either package reads: the data stream is seeded by its YAML
    and resumes exactly (``ResumableIterator``)."""

    output_dir: str = "runs/sft"
    save_steps: int = 1000
    log_steps: int = 10
    resume: bool = False
    seed: int = 42
    trackers: tuple = ("jsonl", "tensorboard")
    expr_name: str = ""


def train_loop(agent: nn.Module, vit: Optional[nn.Module],
               data_iter: Iterator[Dict[str, np.ndarray]],
               train_cfg: TrainConfig, run_cfg: RunConfig,
               device="cuda", mesh=None) -> TrainState:
    """Train ``agent`` (its trainable leaves become fp32 parameters in
    place) on ``data_iter`` until ``train_cfg.max_steps``; returns the
    final state.  A logged step's metrics add ``vit_ms`` (the frozen
    encode), ``tokens`` (attention-mask tokens trained on, this rank's)
    and ``steps_per_sec`` to the train step's.  With a ``mesh`` the agent
    and the ViT are placed on it first (``parallel/mesh.place_params``)
    and ``data_iter`` yields this rank's rows of each global batch; the
    state then holds this rank's shards."""
    device = torch.device(device)
    agent.to(device)
    if vit is not None:
        vit.to(device)
    if mesh is not None:
        from seedx_tpu_torch.parallel.mesh import place_params

        place_params(agent, mesh)
        if vit is not None:
            place_params(vit, mesh)
    os.makedirs(run_cfg.output_dir, exist_ok=True)
    ckpt = CheckpointManager(os.path.join(run_cfg.output_dir, "checkpoints"))
    state = create_train_state(agent, train_cfg)
    if run_cfg.resume and ckpt.latest_step() is not None:
        restore_train_state(ckpt, state, agent)
        logger.info("resumed from step %d", state.step)
    train_step = make_train_step(agent, train_cfg)
    accum = train_cfg.gradient_accumulation_steps
    if state.step:
        # exact data resume: skip every batch this rank already trained on
        data_iter = ResumableIterator(data_iter)
        skipped = data_iter.skip(state.step * accum)
        logger.info("data stream fast-forwarded %d batches", skipped)
    if accum > 1:
        data_iter = _stack_microbatches(data_iter, accum)
    t_last = time.perf_counter()
    # on a mesh every rank holds the global metrics: the first one logs
    first = mesh is None or torch.distributed.get_rank() == 0
    with MetricWriters(run_cfg.output_dir,
                       trackers=run_cfg.trackers if first else (),
                       expr_name=run_cfg.expr_name) as writers:
        for batch in data_iter:
            step = state.step
            if step >= train_cfg.max_steps:
                break
            dev_batch = _to_device(_same_rows(batch, mesh), device)
            t0 = sync_time(device)
            if vit is not None and "images" in dev_batch:
                dev_batch["image_embeds"] = _encode(
                    vit, dev_batch.pop("images"),
                    dev_batch.get("patch_positions"), accum > 1)
            vit_ms = (sync_time(device) - t0) * 1e3
            gen = torch.Generator(device=device)
            gen.manual_seed(run_cfg.seed * 1_000_003 + step)
            metrics = train_step(state, dev_batch, gen)
            if step % run_cfg.log_steps == 0:
                now = time.perf_counter()
                metrics.update(
                    vit_ms=vit_ms,
                    tokens=int(dev_batch["attention_mask"].sum()),
                    steps_per_sec=run_cfg.log_steps / max(now - t_last,
                                                          1e-9))
                t_last = now
                writers.log(metrics, step)
                logger.info("step %d: %s", step, metrics)
            if step > 0 and step % run_cfg.save_steps == 0:
                save_train_state(ckpt, state, agent, step)
    save_train_state(ckpt, state, agent)
    return state


@torch.no_grad()
def _encode(vit: nn.Module, images: torch.Tensor,
            patch_positions: Optional[torch.Tensor],
            accum_axis: bool) -> torch.Tensor:
    """The frozen ViT forward (reference train_seed_x_sft.py:293-299
    no_grad); a leading accumulation axis is folded into one pass."""
    if not accum_axis:
        return vit(images, patch_positions)
    a, n = images.shape[:2]
    embeds = vit(images.reshape(a * n, *images.shape[2:]),
                 None if patch_positions is None
                 else patch_positions.reshape(a * n, 2))
    return embeds.reshape(a, n, *embeds.shape[1:])


def _stack_microbatches(it: Iterator[Dict[str, np.ndarray]], accum: int
                        ) -> Iterator[Dict[str, np.ndarray]]:
    """Group ``accum`` consecutive micro-batches into one batch with a
    leading micro-batch axis."""
    group = []
    for b in it:
        group.append(b)
        if len(group) == accum:
            yield {k: np.stack([g[k] for g in group]) for k in group[0]}
            group = []


def _same_rows(batch: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """On a mesh with ``tensor`` > 1, the batch of the first rank of this
    rank's tensor group, on every rank of it: tensor peers compute on the
    same rows, and though they read the same files, the threaded tar
    reader interleaves its shards in no fixed order."""
    if mesh is None or mesh.size(mesh.mesh_dim_names.index("tensor")) == 1:
        return batch
    import torch.distributed as dist

    group = mesh.get_group("tensor")
    box = [batch]
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    return box[0]


def _to_device(batch: Dict[str, np.ndarray],
               device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; integer arrays as int64.

    On a mesh the batch is this rank's rows: the JAX package's
    per-process contract (``put_global``) with one process a card, so the
    local batch is the rank's whole share of the keys JAX shards ("batch"
    and "images" over data x fsdp), kept as plain tensors for the kernels.
    JAX's rule for a dim that does not divide the shards a process holds
    (replicate in one process, raise across processes) has no case here:
    a process holds one shard."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point() and t.dtype != torch.bool:
            t = t.long()
        out[k] = t.to(device)
    return out


def main(argv: Optional[Sequence[str]] = None) -> TrainState:
    """CLI mirroring the reference's HfArgumentParser entry
    (train_seed_x_sft.py:32-75): YAML object-graph configs + flags.
    Returns the final train state."""
    p = argparse.ArgumentParser()
    p.add_argument("--image_transform", required=True)
    p.add_argument("--tokenizer", required=True)
    p.add_argument("--visual_encoder", required=True)
    p.add_argument("--agent_model", required=True)
    p.add_argument("--train_dataset", required=True)
    p.add_argument("--output_dir", default="runs/sft")
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--weight_decay", type=float, default=0.05)
    p.add_argument("--max_steps", type=int, default=20000)
    p.add_argument("--warmup_steps", type=int, default=500)
    p.add_argument("--min_lr_ratio", type=float, default=0.05)
    p.add_argument("--save_steps", type=int, default=1000)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--expr_name", default="",
                   help="experiment name for trackers (reference: "
                        "--expr_name)")
    p.add_argument("--trackers", default="jsonl,tensorboard",
                   help="comma list of metric writers: jsonl, tensorboard, "
                        "wandb (reference logs to tensorboard+wandb via "
                        "accelerate, train_seed_x_sft.py:147-156)")
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--parallel", default=None,
                   help="mesh layout YAML (configs/parallel/*.yaml): one "
                        "process a card under torchrun's environment")
    p.add_argument("--device", default="cuda",
                   help="torch device the run trains on (cpu for a debug "
                        "run)")
    args = p.parse_args(argv)
    maybe_initialize(args.device)
    # the mesh first: the datasets shard their files by its batch axes
    mesh = (config_lib.instantiate_from_file(
        args.parallel, device_type=torch.device(args.device).type)
        if args.parallel else None)

    transform = config_lib.instantiate_from_file(args.image_transform)
    tokenizer = config_lib.instantiate_from_file(args.tokenizer)
    vit = config_lib.instantiate_from_file(args.visual_encoder,
                                           device=args.device)
    agent = config_lib.instantiate_from_file(args.agent_model,
                                             device=args.device)
    data_cfg = config_lib.load_config(args.train_dataset)
    data_iter = config_lib.instantiate(
        data_cfg, tokenizer=tokenizer, image_transform=transform)

    train_cfg = TrainConfig(
        learning_rate=args.learning_rate, weight_decay=args.weight_decay,
        max_steps=args.max_steps, warmup_steps=args.warmup_steps,
        min_lr_ratio=args.min_lr_ratio,
        gradient_accumulation_steps=args.gradient_accumulation_steps)
    run_cfg = RunConfig(output_dir=args.output_dir,
                        save_steps=args.save_steps, resume=args.resume,
                        trackers=tuple(
                            t for t in args.trackers.split(",") if t),
                        expr_name=args.expr_name)
    return train_loop(agent, vit, data_iter, train_cfg, run_cfg,
                      device=args.device, mesh=mesh)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
