"""Step-indexed checkpoints and one-shot state files (reference:
seedx_tpu/train/checkpoints.py, which writes orbax trees).

``{directory}/checkpoint-{step}/state.pt`` holds ``torch.save`` of what
``TrainState.state_dict`` gives: the step, the trainable leaves and the
optimizer state.  The frozen weights are never written.  A save goes to a
temporary directory first and is renamed into place, so a crash leaves
either the old checkpoint or the new one.

The file holds whole leaves, whatever the layout that wrote it, as an
orbax checkpoint is one logical artifact: on a mesh ``save_train_state``
gathers every trainable leaf and its Adam moments (a collective), the
first rank writes them and every rank waits at a barrier until the
rename is done; ``restore_train_state`` reads the file on every rank and
keeps each rank's shard (``parallel/mesh.local_part``), so a checkpoint
written on one layout restores on any other, or on one device.
``save_pytree`` /
``restore_pytree`` write and read one state dict (an exported serving
artifact, ``utils/export.py``) the same way.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Mapping, Optional

import torch

_NAME = re.compile(r"checkpoint-(\d+)$")


class CheckpointManager:
    """``{directory}/checkpoint-{step}`` (the reference's naming,
    train_seed_x_sft.py:325-327); ``max_to_keep`` None keeps all."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in
                      map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Mapping[str, Any]) -> str:
        final = self.path(step)
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        if self.max_to_keep is not None:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.path(old), ignore_errors=True)
        return final

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Mapping[str, Any]:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(os.path.join(self.path(step), "state.pt"),
                          map_location=map_location, weights_only=True)


def save_pytree(path: str, tree: Mapping[str, Any]) -> None:
    """One-shot save of a state dict (nested mappings of tensors), its
    tensors copied to the host first so the file loads on any device;
    written to ``path + ".tmp"`` and renamed into place."""
    def host(node):
        if isinstance(node, Mapping):
            return {k: host(v) for k, v in node.items()}
        return node.detach().cpu() if isinstance(node, torch.Tensor) \
            else node

    tmp = path + ".tmp"
    torch.save(host(tree), tmp)
    os.replace(tmp, path)


def restore_pytree(path: str, template: Any = None) -> Any:
    """Read what ``save_pytree`` wrote (tensors over a map of the file).
    With a module as ``template`` the state is copied into it (strict:
    every buffer present, every leaf used) and the module comes back."""
    state = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    if template is None:
        return state
    with torch.no_grad():
        template.load_state_dict(state, strict=True)
    return template


def _layouts(model, names):
    from seedx_tpu_torch.parallel.mesh import leaf_layout

    return {n: leaf_layout(model, n) for n in names}


def save_train_state(manager: CheckpointManager, state, model,
                     step: Optional[int] = None) -> str:
    """Write ``state`` (a ``trainer.TrainState`` over ``model``'s
    trainable leaves) as checkpoint ``step`` (default ``state.step``),
    whole leaves whatever the mesh (see the module docstring)."""
    step = state.step if step is None else step
    import torch.distributed as dist

    from seedx_tpu_torch.parallel.mesh import gather_full
    from seedx_tpu_torch.train.trainer import mesh_groups

    groups = mesh_groups(model)
    if groups is None:
        return manager.save(step, state.state_dict())
    layouts = _layouts(model, state.params)
    sd = state.state_dict()

    def whole(tree):
        return {n: gather_full(t, layouts[n], groups).cpu()
                for n, t in tree.items()}

    full = {"step": sd["step"], "trainable": whole(sd["trainable"]),
            "opt_state": {k: whole(v) for k, v in sd["opt_state"].items()}}
    path = manager.path(step)
    if dist.get_rank() == 0:
        path = manager.save(step, full)
    dist.barrier()
    return path


def restore_train_state(manager: CheckpointManager, state, model,
                        step: Optional[int] = None) -> None:
    """Load checkpoint ``step`` (default: the latest) into ``state``: on a
    mesh each rank keeps its shard of every whole leaf."""
    from seedx_tpu_torch.parallel.mesh import local_part
    from seedx_tpu_torch.train.trainer import mesh_groups

    groups = mesh_groups(model)
    device = next(iter(state.params.values())).device
    saved = manager.restore(step, map_location="cpu" if groups is not None
                            else device)
    if groups is not None:
        layouts = _layouts(model, state.params)

        def mine(tree):
            return {n: local_part(t, layouts[n], groups.mesh)
                    for n, t in tree.items()}

        saved = {"step": saved["step"], "trainable": mine(saved["trainable"]),
                 "opt_state": {k: mine(v) for k, v in
                               saved["opt_state"].items()}}
    state.load_state_dict(saved)
