"""One rank of a CPU mesh for tests/test_torch_sharding.py.

    python tests/test_torch_shard_worker.py SCENARIO RANK WORLD DIR

joins a gloo group of WORLD ranks through a ``FileStore`` in DIR (no
ports), reads its inputs from DIR/in.npz (weights as flattened JAX trees,
``/``-joined paths), runs SCENARIO and writes DIR/out<RANK>.npz.  It
imports torch and the port only, never JAX, and holds no test of its own.
"""

import itertools
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist


def tree(inp, prefix: str) -> dict:
    """The nested JAX tree stored under ``prefix/`` in the npz."""
    out = {}
    for key in inp.files:
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *path, leaf = key[len(prefix) + 1:].split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = inp[key]
    return out


def _js(x) -> np.ndarray:
    return np.array(json.dumps(x))


def runtime(rank, inp):
    """The debug runtime with its adapter on the mesh ``inp["mesh"]``: the
    agent forward, comprehend, the continuous engine, the denoise, the
    per-rank shard sizes and ``put_global``."""
    from PIL import Image

    from seedx_tpu_torch.inference import apps
    from seedx_tpu_torch.inference.continuous import ContinuousEngine
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models import adapter as tadapter
    from seedx_tpu_torch.parallel import create_mesh, mesh_sharding
    from seedx_tpu_torch.parallel.distributed import put_global
    from seedx_tpu_torch.utils.convert import load_jax_params

    rt = SeedXRuntime.debug(dtype=torch.float32, device="cpu",
                            with_adapter=True)
    ad = rt.adapter
    for module, key in ((rt.vit, "vit"), (rt.agent, "agent"),
                        (ad.unet, "unet"), (ad.resampler, "resampler"),
                        (ad.vae_decoder, "vae_decoder"),
                        (ad.vae_encoder, "vae_encoder")):
        load_jax_params(module, tree(inp, key))
    noise = torch.from_numpy(inp["noise"])
    tadapter.prepare_latents = (
        lambda generator, batch, cfg, schedule, dtype=torch.float32:
        noise.to(dtype) * schedule.init_noise_sigma)

    mesh = create_mesh(*map(int, inp["mesh"]))
    rt.shard(mesh)
    out = {"local_numel": _js({k: v.numel() for m, p in
                               ((rt.vit, "vit."), (rt.agent, "agent."))
                               for k, v in ((p + n, t) for n, t in
                                            m.state_dict().items())}),
           "graphs": np.array(rt.graphs.enabled)}
    with torch.no_grad():
        ids = torch.from_numpy(inp["ids"])
        pos = torch.arange(ids.shape[1]).repeat(ids.shape[0], 1)
        out["logits"] = rt.agent.llm(rt.agent.embed_ids(ids), pos)[0].numpy()
        # this rank's rows (its fsdp coordinate's) of the global batch:
        # the global loss is the ranks' losses summed over the batch axes
        par = rt.agent.llm.lm_head._par
        sft = batch_rows({k[4:]: torch.from_numpy(inp[k]) for k in inp.files
                          if k.startswith("sft_")}, par.batch_index,
                         par.batch_count)
        out["total_loss"] = par.batch_sum(
            rt.agent(**sft)["total_loss"]).numpy()
    image = Image.fromarray(inp["image"])
    out["comprehend"] = np.asarray(apps.comprehend(
        rt, image, "what?", max_new_tokens=4)["tokens"])
    eng = ContinuousEngine(rt, slots=2, max_new_tokens=6, chunk_steps=3,
                           prompt_buckets=(64,))
    base = {"image_embeds": None, "embeds_cmp_mask": None,
            "ids_cmp_mask": None, "patch_positions": None}
    ids_ = [eng.submit(dict(base, input_ids=r))
            for r in json.loads(str(inp["requests"]))]
    res = eng.run()
    out["engine"] = _js([[list(map(int, res[i]["tokens"])),
                          bool(res[i]["has_img_output"])] for i in ids_])
    feats = [res[i]["img_gen_feat"] for i in ids_]
    for i, f in enumerate(feats):
        if f is not None:
            out[f"feat{i}"] = f.float().numpy()
    embeds = rt.encode_image_single(image)
    out["denoise"] = ad.generate(embeds, from_vit=True, num_inference_steps=3)
    # the per-rank batch contract: this rank's slice of a global batch
    # (ranks with the same (data, fsdp) coordinate read the same slice)
    x = torch.full((2, 3), float(mesh.get_local_rank("fsdp")))
    g = put_global(x, mesh_sharding(mesh, "batch", None))
    out["global"] = g.full_tensor().numpy()
    out["local"] = g.to_local().numpy()
    return out


def rowpar(rank, inp):
    """The int4 LLaMA at tensor 2 (down_proj row-parallel: its rows
    quantized against the whole row's absmax), against the unsharded
    model, and the mutant that quantizes each shard against its own."""
    from seedx_tpu_torch.models.llama import LlamaForCausalLM, llama_debug
    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.distributed import MeshGroups
    from seedx_tpu_torch.parallel.mesh import place_params
    from seedx_tpu_torch.utils.convert import load_jax_params

    cfg = llama_debug(hidden_size=128, intermediate_size=256, num_layers=2,
                      num_heads=4, num_kv_heads=4, quantization="int4",
                      dtype=torch.float32)
    llm = load_jax_params(LlamaForCausalLM(cfg), tree(inp, "llm"))
    ids = torch.from_numpy(inp["ids"])
    pos = torch.arange(ids.shape[1]).repeat(ids.shape[0], 1)
    out = {}
    with torch.no_grad():
        out["full"] = llm(llm.embed(ids), pos)[0].numpy()
        place_params(llm, create_mesh(1, 1, 2))
        out["roles"] = _js({n: llm.layers.get_submodule(n).tp for n in
                            ("q_proj", "o_proj", "gate_proj", "down_proj")})
        out["sharded"] = llm(llm.embed(ids), pos)[0].numpy()
        real = MeshGroups.all_reduce
        MeshGroups.all_reduce = (lambda self, x, axis="tensor", op="sum":
                                 x if op == "max" else real(self, x, axis,
                                                            op))
        try:
            out["mutant"] = llm(llm.embed(ids), pos)[0].numpy()
        finally:
            MeshGroups.all_reduce = real
    return out


def vocab(rank, inp):
    """A LLaMA at tensor 4: with ``vocab_pad_to`` 32336 its logits; without
    padding the placement's error."""
    from seedx_tpu_torch.models.llama import LlamaForCausalLM, llama_debug
    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.mesh import place_params
    from seedx_tpu_torch.utils.convert import load_jax_params

    kw = dict(hidden_size=128, intermediate_size=256, num_layers=2,
              num_heads=4, num_kv_heads=4, dtype=torch.float32)
    mesh = create_mesh(1, 1, 4)
    out = {}
    try:
        place_params(LlamaForCausalLM(llama_debug(**kw)), mesh)
        out["error"] = np.array("")
    except ValueError as e:
        out["error"] = np.array(str(e))
    llm = load_jax_params(LlamaForCausalLM(llama_debug(
        vocab_pad_to=32336, **kw)), tree(inp, "llm"))
    place_params(llm, mesh)
    ids = torch.from_numpy(inp["ids"])
    pos = torch.arange(ids.shape[1]).repeat(ids.shape[0], 1)
    with torch.no_grad():
        out["logits"] = llm(llm.embed(ids), pos)[0].numpy()
    out["table_rows"] = np.array(llm.embed_tokens.embedding.shape[0])
    return out


# ---- the split denoise ------------------------------------------------------

def denoise(rank, inp):
    """The debug runtime's adapter (the 8-channel edit UNet, 3-way CFG),
    unsharded and then split on the mesh ``inp["mesh"]``: ``generate``
    from ViT features, without (text to image) and with a condition image
    (edit); with ``inp["mutants"]`` the split run again with zeros for
    every halo, and with GroupNorm's local statistics."""
    from seedx_tpu_torch.inference.runtime import SeedXRuntime
    from seedx_tpu_torch.models import adapter as tadapter
    from seedx_tpu_torch.ops import norms
    from seedx_tpu_torch.parallel import create_mesh
    from seedx_tpu_torch.parallel.distributed import (COLLECTIVES,
                                                      MeshGroups)
    from seedx_tpu_torch.utils.convert import load_jax_params

    rt = SeedXRuntime.debug(dtype=torch.float32, device="cpu",
                            with_adapter=True)
    ad = rt.adapter
    for module, key in ((rt.vit, "vit"), (ad.unet, "unet"),
                        (ad.resampler, "resampler"),
                        (ad.vae_decoder, "vae_decoder"),
                        (ad.vae_encoder, "vae_encoder")):
        load_jax_params(module, tree(inp, key))
    noise = torch.from_numpy(inp["noise"])
    tadapter.prepare_latents = (
        lambda generator, batch, cfg, schedule, dtype=torch.float32:
        noise.to(dtype) * schedule.init_noise_sigma)
    embeds = torch.from_numpy(inp["embeds"])
    cond = torch.from_numpy(inp["cond"])
    steps = int(inp["steps"])

    def both(tag, out):
        out[f"t2i{tag}"] = ad.generate(embeds, from_vit=True,
                                       num_inference_steps=steps)
        out[f"edit{tag}"] = ad.generate(embeds, latent_image=cond,
                                        from_vit=True,
                                        num_inference_steps=steps)

    out = {}
    both("_full", out)
    ad.shard(create_mesh(*map(int, inp["mesh"])))
    before = dict(COLLECTIVES)
    out["t2i"] = ad.generate(embeds, from_vit=True,
                             num_inference_steps=steps)
    out["collectives"] = _js({k: COLLECTIVES[k] - before[k]
                              for k in COLLECTIVES})
    out["edit"] = ad.generate(embeds, latent_image=cond, from_vit=True,
                              num_inference_steps=steps)
    if bool(inp["mutants"]):
        real_halo, real_gn = MeshGroups.halo, norms.group_norm_fp32_stats

        def zero_halo(self, x, top, bottom, axis="tensor", dim=1):
            z = x.new_zeros(x.shape[:dim] + (1,) + x.shape[dim + 1:])
            return torch.cat([z.expand(*x.shape[:dim], top,
                                       *x.shape[dim + 1:]), x,
                              z.expand(*x.shape[:dim], bottom,
                                       *x.shape[dim + 1:])], dim)

        def local_gn(x, scale, bias, groups, eps=1e-5, reduce=None,
                     parts=1):
            return real_gn(x, scale, bias, groups, eps)

        try:
            MeshGroups.halo = zero_halo
            out["t2i_zero_halo"] = ad.generate(embeds, from_vit=True,
                                               num_inference_steps=steps)
        finally:
            MeshGroups.halo = real_halo
        try:
            norms.group_norm_fp32_stats = local_gn
            out["t2i_local_gn"] = ad.generate(embeds, from_vit=True,
                                              num_inference_steps=steps)
        finally:
            norms.group_norm_fp32_stats = real_gn
    return out


# ---- training on a mesh ------------------------------------------------------

TRAIN_KW = dict(learning_rate=1e-3, warmup_steps=0, max_steps=10)


def tiny_train_agent(cfg_json, state=None):
    """The tiny SFT agent of ``cfg_json`` ({"llm": llama_debug kwargs,
    "agent": AgentConfig kwargs}), fp32, on the CPU, with ``state`` ({port
    state name: array}) loaded."""
    from seedx_tpu_torch.models import agent as tagent
    from seedx_tpu_torch.models.llama import llama_debug

    cfg = json.loads(cfg_json)
    agent = tagent.ContinuousLVLM(tagent.AgentConfig(
        llm=llama_debug(dtype=torch.float32, **cfg["llm"]),
        dtype=torch.float32, **cfg["agent"]))
    if state is not None:
        with torch.no_grad():
            agent.load_state_dict({k: torch.as_tensor(v)
                                   for k, v in state.items()})
    return agent


def batch_rows(batch, index: int, count: int) -> dict:
    """Rows [index * b, (index + 1) * b) of every key of a global batch
    of count * b rows (one image a row)."""
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // count
        out[k] = v[index * b:(index + 1) * b]
    return out


def torch_batch(batch) -> dict:
    return {k: (torch.from_numpy(v).long() if v.dtype in (np.int32, np.int64)
                else torch.from_numpy(v)) for k, v in batch.items()}


def train(rank, inp):
    """The data pipeline's file shards and mixed stream on the mesh
    ``inp["mesh"]``, then each run of ``inp["runs"]`` from the same
    weights: train steps of the tiny agent on the mesh, on this rank's
    rows of the global batch ``batch/*``, with each step's metrics and
    every trainable leaf, whole, after it.  A run's ``dropout`` passes the
    steps a generator; ``mutant``: "mean_of_means" (each rank's LM loss
    its own mean), "no_f" (no all-reduce of dx at a column-parallel
    input), "no_gather_grad" (an fsdp-gathered leaf's gather without its
    backward); ``save`` / ``restore``: a checkpoint directory to write
    after the steps / to restore before them."""
    from seedx_tpu_torch.data import pipeline as tpipe
    from seedx_tpu_torch.parallel import create_mesh

    mesh = create_mesh(*map(int, inp["mesh"]), device_type="cpu")
    out = {"files": _js(tpipe.shard_files([f"f{i}" for i in range(8)])),
           "mix": _js([int(x) for x in itertools.islice(tpipe.weighted_mix(
               [iter(range(0, 100)), iter(range(100, 200))], [0.5, 0.5]),
               12)])}
    for i, run in enumerate(json.loads(str(inp["runs"]))):
        for k, v in train_run(inp, mesh, run).items():
            out[f"run{i}/{k}"] = v
    return out


def train_run(inp, mesh, run) -> dict:
    from seedx_tpu_torch.models import agent as tagent
    from seedx_tpu_torch.models import llama as tllama
    from seedx_tpu_torch.parallel.distributed import MeshGroups
    from seedx_tpu_torch.parallel.mesh import (gather_full, leaf_layout,
                                               place_params)
    from seedx_tpu_torch.train import checkpoints as tckpt
    from seedx_tpu_torch.train.trainer import (TrainConfig,
                                               create_train_state,
                                               make_train_step, mesh_groups)

    agent = tiny_train_agent(str(inp["cfg"]), tree(inp, "state"))
    place_params(agent, mesh)
    tcfg = TrainConfig(**TRAIN_KW)
    state = create_train_state(agent, tcfg)
    step = make_train_step(agent, tcfg)
    groups = mesh_groups(agent)
    batch = torch_batch(batch_rows(tree(inp, "batch"), groups.batch_index,
                                   groups.batch_count))
    out = {}

    def whole(tag):
        # gathered on every rank (a collective), kept by the first
        for n, p in state.params.items():
            t = gather_full(p.detach(), leaf_layout(agent, n), groups)
            if dist.get_rank() == 0:
                out[f"{tag}/{n}"] = t.numpy().copy()

    patched = {"mean_of_means": (tagent, "causal_lm_loss", (
                   lambda logits, labels, groups=None:
                   tllama.causal_lm_loss(logits, labels)
                   / groups.batch_count)),
               "no_f": (MeshGroups, "copy_to",
                        lambda self, x, axis="tensor": x),
               "no_gather_grad": (MeshGroups, "gather_leaf", (
                   lambda self, t, dim, axis:
                   self.all_gather(t.detach(), dim, axis)))}.get(
        run.get("mutant"))
    real = None
    if patched is not None:
        real = getattr(patched[0], patched[1])
        setattr(patched[0], patched[1], patched[2])
    try:
        if run.get("restore"):
            tckpt.restore_train_state(tckpt.CheckpointManager(
                run["restore"]), state, agent)
            out["restored_step"] = np.array(state.step)
            whole("restored")
        metrics = []
        for i in range(run["steps"]):
            gen = None
            if run.get("dropout"):
                gen = torch.Generator().manual_seed(1000 + state.step)
            metrics.append(step(state, batch, gen))
            whole(f"leaf{i}")
    finally:
        if patched is not None:
            setattr(patched[0], patched[1], real)
    out["metrics"] = _js([{k: v for k, v in m.items()
                           if not k.endswith("_ms")} for m in metrics])
    if run.get("save"):
        tckpt.save_train_state(tckpt.CheckpointManager(run["save"]), state,
                               agent)
    return out


def cli(rank, inp):
    """``train_sft.main(argv)`` on this group (``--parallel`` a repo
    YAML): the local batch of each step as the loop hands it to the
    device, the weights the loop started from, and the trainable leaves,
    whole, at the end."""
    from seedx_tpu_torch.parallel.mesh import gather_full, leaf_layout
    from seedx_tpu_torch.train import train_sft
    from seedx_tpu_torch.train.trainer import mesh_groups

    seen = {"batches": []}
    real_to_device, real_loop = train_sft._to_device, train_sft.train_loop

    def spy_to_device(batch, *a, **kw):
        seen["batches"].append(batch)
        return real_to_device(batch, *a, **kw)

    def spy_loop(agent, vit, *a, **kw):
        seen["agent"], seen["vit"] = agent, vit
        seen["init"] = {f"{p}/{k}": v.float().numpy().copy()
                        for p, m in (("agent", agent), ("vit", vit))
                        for k, v in m.state_dict().items()}
        return real_loop(agent, vit, *a, **kw)

    train_sft._to_device, train_sft.train_loop = spy_to_device, spy_loop
    os.environ["SEEDX_DEBUG"] = "1"
    state = train_sft.main(json.loads(str(inp["argv"])))
    agent = seen["agent"]
    groups = mesh_groups(agent)
    first = dist.get_rank() == 0      # the weights are kept by the first
    out = {"step": np.array(state.step), "batch_index":
           np.array(groups.batch_index), **(seen["init"] if first else {})}
    for i, b in enumerate(seen["batches"]):
        for k, v in b.items():
            out[f"batch{i}/{k}"] = v
    for n, p in state.params.items():
        t = gather_full(p.detach(), leaf_layout(agent, n), groups)
        if first:
            out[f"leaf/{n}"] = t.numpy().copy()
    return out


SCENARIOS = {"runtime": runtime, "rowpar": rowpar, "vocab": vocab,
             "denoise": denoise, "train": train, "cli": cli}


def main() -> None:
    scenario, rank, world, d = (sys.argv[1], int(sys.argv[2]),
                                int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world), rank=rank, world_size=world)
    inp = np.load(os.path.join(d, "in.npz"))
    out = SCENARIOS[scenario](rank, inp)
    np.savez(os.path.join(d, f"out{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
