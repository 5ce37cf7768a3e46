"""Two-process worker of tests/test_torch_multiprocess.py: the port's
counterpart of tests/multiproc_worker.py, over two CPU processes that meet
through torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``):

  * ``parallel.distributed.maybe_initialize(device="cpu")`` (gloo),
  * per-process file sharding (``data/pipeline.shard_files``): disjoint and
    complete across the processes,
  * the tiny agent's sharded train step on ``create_mesh(data=1, fsdp=2,
    tensor=1)``, each process passing its rows of one global batch
    (``train_sft._to_device``),
  * a checkpoint saved and restored across the process boundary
    (``train/checkpoints.save_train_state`` / ``restore_train_state``)
    into a second placed agent, leaf for leaf, and a further step from
    the restored state.

Each process prints one ``METRICS`` line and one ``MULTIPROC OK`` line;
the test asserts both processes agree.  It imports torch and the port
only and holds no test of its own.

    RANK=0 WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 MASTER_PORT=29500 \\
        python tests/test_torch_multiproc_worker.py OUT_DIR
"""

import json
import os
import sys

import numpy as np
import torch

SEED = 0


def tiny_agent():
    """The JAX worker's agent (hidden 128, 2 layers, 4 heads, LoRA r8, 4
    image tokens), fp32 on the CPU, its weights drawn from ``SEED``."""
    from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
    from seedx_tpu_torch.models.layers import init_normal_
    from seedx_tpu_torch.models.llama import llama_debug

    cfg = AgentConfig(llm=llama_debug(hidden_size=128, intermediate_size=256,
                                      num_layers=2, num_heads=4,
                                      num_kv_heads=4, lora_rank=8,
                                      dtype=torch.float32),
                      vit_dim=64, resampler_heads=4, num_img_in_tokens=4,
                      num_img_out_tokens=4, dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    return init_normal_(ContinuousLVLM(cfg), gen)


def global_batch():
    """The JAX worker's global batch: B 4, S 64, 4 images of 16 tokens."""
    b, s, n, t = 4, 64, 4, 16
    rng = np.random.RandomState(7)
    ids = rng.randint(5, 30000, (b, s)).astype(np.int32)
    attn = np.ones((b, s), bool)
    labels = np.where(attn, ids, -100).astype(np.int32)
    image_embeds = rng.randn(n, t, 64).astype(np.float32) * 0.1
    embeds_cmp = np.array([True, True, False, False])
    ids_cmp = np.zeros((b, s), bool)
    ids_cmp[0, 1:5] = ids_cmp[1, 3:7] = True
    ids_gen = np.zeros((b, s), bool)
    ids_gen[2, 2:6] = ids_gen[3, 5:9] = True
    return dict(input_ids=ids, attention_mask=attn, labels=labels,
                image_embeds=image_embeds, embeds_gen_mask=~embeds_cmp,
                embeds_cmp_mask=embeds_cmp, ids_gen_mask=ids_gen,
                ids_cmp_mask=ids_cmp,
                patch_positions=np.full((n, 2), 0.5, np.float32))


TRAIN_KW = dict(max_steps=4, warmup_steps=1)


def metrics_of(m: dict) -> dict:
    return {k: v for k, v in m.items() if not k.endswith("_ms")}


def main(out_dir: str) -> None:
    import torch.distributed as dist

    from seedx_tpu_torch.data.pipeline import shard_files
    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.distributed import maybe_initialize
    from seedx_tpu_torch.parallel.mesh import place_params
    from seedx_tpu_torch.train.checkpoints import (CheckpointManager,
                                                   restore_train_state,
                                                   save_train_state)
    from seedx_tpu_torch.train.train_sft import _to_device
    from seedx_tpu_torch.train.trainer import (TrainConfig,
                                               create_train_state,
                                               make_train_step)

    torch.set_num_threads(1)
    assert maybe_initialize(device="cpu")
    assert dist.get_world_size() == 2, dist.get_world_size()
    pid = dist.get_rank()

    # per-process file sharding: disjoint + complete
    files = [f"shard-{i:03d}" for i in range(7)]
    mine = shard_files(files)
    assert mine == files[pid::2], (pid, mine)

    mesh = create_mesh(data=1, fsdp=2, tensor=1, device_type="cpu")
    assert shard_files(files) == mine
    rows = slice(pid * 2, pid * 2 + 2)       # this process's data shard
    local = {k: v[rows] for k, v in global_batch().items()}
    cpu = torch.device("cpu")
    batch = _to_device(local, cpu)

    cfg = TrainConfig(**TRAIN_KW)
    agent = place_params(tiny_agent(), mesh)
    state = create_train_state(agent, cfg)
    step = make_train_step(agent, cfg)
    m1 = metrics_of(step(state, batch, torch.Generator().manual_seed(1)))
    m2 = metrics_of(step(state, batch, torch.Generator().manual_seed(2)))
    print(f"METRICS {json.dumps([m1, m2], sort_keys=True)}", flush=True)

    # the checkpoint across the process boundary, into a second agent
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpts"))
    save_train_state(ckpt, state, agent)
    agent2 = place_params(tiny_agent(), mesh)
    restored = create_train_state(agent2, cfg)
    restore_train_state(ckpt, restored, agent2)
    diff = torch.zeros(())
    for n, p in state.params.items():
        trees = [(p, restored.params[n])] + [
            (state.opt_state[k][n], restored.opt_state[k][n])
            for k in ("mu", "nu")]
        for a, b in trees:
            diff = torch.maximum(diff, (a.detach() - b.detach()).abs().max())
    dist.all_reduce(diff, op=dist.ReduceOp.MAX)
    assert restored.step == state.step == 2
    assert float(diff) == 0.0, f"restore mismatch: max diff {float(diff)}"

    # the restored state is live: one more step
    step2 = make_train_step(agent2, cfg)
    m3 = metrics_of(step2(restored, batch, torch.Generator().manual_seed(3)))
    print(f"MULTIPROC OK {json.dumps(m3, sort_keys=True)}", flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
