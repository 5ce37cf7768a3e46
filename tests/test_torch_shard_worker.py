"""One rank of a CPU mesh for tests/test_torch_sharding.py.

    python tests/test_torch_shard_worker.py SCENARIO RANK WORLD DIR

joins a gloo group of WORLD ranks through a ``FileStore`` in DIR (no
ports), reads its inputs from DIR/in.npz (weights as flattened JAX trees,
``/``-joined paths), runs SCENARIO and writes DIR/out<RANK>.npz.  It
imports torch and the port only, never JAX, and holds no test of its own.
"""

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
        sft = {k[4:]: torch.from_numpy(inp[k]) for k in inp.files
               if k.startswith("sft_")}
        out["total_loss"] = rt.agent(**sft)["total_loss"].numpy()
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


SCENARIOS = {"runtime": runtime, "rowpar": rowpar, "vocab": vocab}


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
