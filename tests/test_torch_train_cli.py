"""The port's SFT entry point, ``seedx_tpu_torch.train.train_sft.main``:
the JAX package's CLI over the repo's YAML configs and the file
datapipes, on the debug models (``SEEDX_DEBUG=1``) on the CPU.

  * both repo data YAMLs (only their paths rewritten to synthetic files)
    train for 2 steps, save, and resume to a third;
  * every YAML under ``configs/`` resolves to a target of the port
    (``seedx_tpu.`` read as ``seedx_tpu_torch.``), the mesh layouts of
    ``configs/parallel/`` to the port's ``create_mesh``;
  * ``--parallel`` with each repo mesh YAML trains on gloo ranks, as the
    unsharded port does over the same global batches;
  * the first step's loss equals the JAX package's train step loss on the
    same batch and weights to 1e-3 relative (the loss tolerance of
    tests/test_torch_train.py; LoRA dropout off in the agent YAML, since
    the two frameworks draw different masks).
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from seedx_tpu.models import agent as jagent
from seedx_tpu.models import vit as jvit
from seedx_tpu.models.llama import llama_debug as jllama_debug
from seedx_tpu_torch import config as tconfig
from seedx_tpu_torch.parallel.mesh import create_mesh
from seedx_tpu_torch.train import train_sft
from seedx_tpu_torch.train import trainer as ttrainer

from torch_data_fixtures import REPO, data_yamls
from torch_train_fixtures import BATCH_KEYS, jax_tree

torch.set_num_threads(2)

CONFIGS = {k: os.path.join(REPO, "configs", v) for k, v in (
    ("image_transform", "processer/qwen_448_transform.yaml"),
    ("tokenizer", "tokenizer/clm_llama_tokenizer_224loc_anyres.yaml"),
    ("visual_encoder", "visual_encoder/qwen_vitg_448.yaml"),
    ("agent_model", "clm_models/agent_seed_x.yaml"))}
LOSS_REL = 1e-3
PARALLEL_REL = 5e-3
UPDATE_REL = 5e-2


@pytest.fixture
def debug_env(monkeypatch):
    monkeypatch.setenv("SEEDX_DEBUG", "1")


@pytest.fixture(scope="module")
def yamls(tmp_path_factory):
    return data_yamls(str(tmp_path_factory.mktemp("sft_data")))


def _argv(dataset, out, *extra, **configs):
    argv = []
    for k, v in {**CONFIGS, **configs}.items():
        argv += [f"--{k}", v]
    return argv + ["--train_dataset", dataset, "--output_dir", str(out),
                   "--warmup_steps", "0", "--trackers", "jsonl",
                   "--device", "cpu", *extra]


def _metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(x) for x in f]


@pytest.mark.parametrize("name", ["comprehension_gen", "edit"])
def test_main_trains_and_resumes_over_repo_yamls(debug_env, yamls, tmp_path,
                                                 name):
    out = tmp_path / "run"
    state = train_sft.main(_argv(yamls[name], out, "--max_steps", "2",
                                 "--save_steps", "1"))
    assert state.step == 2
    (row,) = _metrics(out)          # every 10th step is logged
    assert row["step"] == 0 and row["tokens"] > 0
    assert np.isfinite(row["total_loss"]) and row["lm_loss"] > 0
    assert sorted(os.listdir(out / "checkpoints")) == ["checkpoint-1",
                                                       "checkpoint-2"]
    trained = {n: p.detach().clone() for n, p in state.params.items()}
    state = train_sft.main(_argv(yamls[name], out, "--max_steps", "3",
                                 "--resume"))
    assert state.step == 3
    assert "checkpoint-3" in os.listdir(out / "checkpoints")
    # the resumed run restored checkpoint-2's leaves (the first run's
    # last state) and one more update moved them
    assert set(state.params) == set(trained)
    assert any(not torch.equal(state.params[n], t)
               for n, t in trained.items())


def _targets(node):
    if isinstance(node, dict):
        if "_target_" in node:
            yield node["_target_"]
        for v in node.values():
            yield from _targets(v)
    elif isinstance(node, list):
        for v in node:
            yield from _targets(v)


def test_every_repo_yaml_resolves_to_the_port():
    found = 0
    meshes = 0
    for root, _, files in os.walk(os.path.join(REPO, "configs")):
        for f in sorted(files):
            with open(os.path.join(root, f)) as fh:
                cfg = yaml.safe_load(fh)
            for target in _targets(cfg):
                obj = tconfig.resolve_target(target)
                assert obj.__module__.startswith("seedx_tpu_torch."), \
                    (f, target, obj.__module__)
                found += 1
                if os.path.basename(root) == "parallel":
                    assert obj is create_mesh, (f, target)
                    meshes += 1
    assert found >= 20 and meshes == 2
    ident = tconfig.instantiate_from_file(os.path.join(
        REPO, "configs/discrete_model/discrete_identity.yaml"))
    x = torch.ones(2, 3)
    assert ident(x) is x and ident.encode_image_embeds(x) is x


@pytest.mark.parametrize("layout", ["fsdp.yaml", "fsdp_tensor.yaml"])
def test_parallel_flag_trains(debug_env, yamls, tmp_path, layout):
    """``--parallel`` with each repo mesh YAML, on 2 gloo ranks of
    ``tests/test_torch_shard_worker.py`` (fsdp 2; fsdp 1 x tensor 2): 2
    steps over the caption datapipe of ``sft_comprehension_gen.yaml`` (2
    shards, one a batch coordinate; tensor peers read the same), LoRA
    dropout off.  The first rank alone logs and writes the checkpoints;
    the logged losses and grad norm match the unsharded port's over the
    ranks' batches
    joined into the global ones to ``PARALLEL_REL`` (the debug models
    compute in bf16, and at tensor 2 each row-parallel partial product is
    rounded to bf16 before the fp32 sum: 1.7e-3 seen; the same steps in
    fp32 agree to 1e-5, tests/test_torch_train_mesh.py), and each
    trainable leaf's change over the 2 steps matches the unsharded one's
    to ``UPDATE_REL`` of its norm (AdamW normalises each element's
    gradient, so an element whose bf16 gradient is near 0 may move by up
    to the learning rate either way: 3% of the embedding table's update
    norm at tensor 2, under 0.2% elsewhere)."""
    from test_torch_sharding import _join, _start

    with open(yamls["comprehension_gen"]) as f:
        data = yaml.safe_load(f)
    data.update(datapipes=data["datapipes"][1:], sample_weights=[1.0])
    data_yaml = tmp_path / "captions.yaml"
    data_yaml.write_text(yaml.safe_dump(data))
    agent_yaml = tmp_path / "agent.yaml"
    with open(CONFIGS["agent_model"]) as f:
        cfg = yaml.safe_load(f)
    cfg["llm"]["lora_dropout"] = 0.0
    agent_yaml.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "run"
    argv = _argv(str(data_yaml), out, "--max_steps", "2", "--save_steps",
                 "1", "--parallel",
                 os.path.join(REPO, "configs/parallel", layout),
                 agent_model=str(agent_yaml))
    ranks = _join(_start("cli", 2, tmp_path, {"argv": np.array(
        json.dumps(argv))}, "ranks"))
    assert [int(r["step"]) for r in ranks] == [2, 2]
    assert sorted(os.listdir(out / "checkpoints")) == ["checkpoint-1",
                                                       "checkpoint-2"]
    (row,) = _metrics(out)
    coords = [int(r["batch_index"]) for r in ranks]
    assert coords == ([0, 1] if layout == "fsdp.yaml" else [0, 0])

    # the unsharded port over the global batches, from the same weights
    agent = tconfig.instantiate_from_file(str(agent_yaml), device="cpu")
    vit = tconfig.instantiate_from_file(CONFIGS["visual_encoder"],
                                        device="cpu")
    with torch.no_grad():
        for prefix, m in (("agent", agent), ("vit", vit)):
            m.load_state_dict({k: torch.from_numpy(ranks[0][f"{prefix}/{k}"])
                               .to(v.dtype) for k, v in
                               m.state_dict().items()})
    train_cfg = ttrainer.TrainConfig(max_steps=2, warmup_steps=0)
    st = ttrainer.create_train_state(agent, train_cfg)
    step = ttrainer.make_train_step(agent, train_cfg)
    firsts = [r for i, r in enumerate(ranks) if coords.index(coords[i]) == i]
    metrics = []
    for i in range(2):
        keys = [k[len(f"batch{i}/"):] for k in ranks[0]
                if k.startswith(f"batch{i}/")]
        batch = {k: np.concatenate([r[f"batch{i}/{k}"] for r in firsts])
                 for k in keys}
        dev = train_sft._to_device(batch, torch.device("cpu"))
        dev["image_embeds"] = train_sft._encode(
            vit, dev.pop("images"), dev.get("patch_positions"), False)
        metrics.append(step(st, dev))
    for k in ("total_loss", "lm_loss", "rec_loss", "grad_norm"):
        assert abs(row[k] - metrics[0][k]) <= PARALLEL_REL * abs(
            metrics[0][k]), (k, row[k], metrics[0][k])
    for n, p in st.params.items():
        init = ranks[0][f"agent/{n}"]
        want = p.detach().numpy() - init
        got = ranks[0][f"leaf/{n}"] - init          # kept by the first rank
        assert np.linalg.norm(got - want) <= UPDATE_REL * max(
            np.linalg.norm(want), 1e-30), n


def test_first_step_loss_matches_jax(debug_env, yamls, tmp_path,
                                     monkeypatch):
    """The batch and weights of ``main``'s first step (captured as
    ``train_loop`` receives them) through the JAX debug ViT and agent:
    the JAX step's loss (``seedx_tpu/train/trainer.py`` loss_fn, no
    dropout) against the loss ``main`` logged at step 0."""
    agent_yaml = tmp_path / "agent.yaml"
    with open(CONFIGS["agent_model"]) as f:
        cfg = yaml.safe_load(f)
    cfg["llm"]["lora_dropout"] = 0.0
    agent_yaml.write_text(yaml.safe_dump(cfg))
    seen = {}
    real_loop = train_sft.train_loop

    def spy(agent, vit, data_iter, *args, **kw):
        seen["agent"] = {k: v.float().numpy().copy()
                         for k, v in agent.state_dict().items()}
        seen["vit"] = {k: v.float().numpy().copy()
                       for k, v in vit.state_dict().items()}
        seen["agent_cfg"], seen["vit_cfg"] = agent.cfg, vit.cfg

        def first(it):
            for i, b in enumerate(it):
                if i == 0:
                    seen["batch"] = b
                yield b

        return real_loop(agent, vit, first(data_iter), *args, **kw)

    monkeypatch.setattr(train_sft, "train_loop", spy)
    out = tmp_path / "run"
    train_sft.main(_argv(yamls["comprehension_gen"], out, "--max_steps",
                         "1", agent_model=str(agent_yaml)))
    got = _metrics(out)[0]["total_loss"]

    acfg, vcfg = seen["agent_cfg"], seen["vit_cfg"]
    assert acfg.llm.lora_dropout == 0.0 and acfg.vit_dim == vcfg.output_dim
    vit_j = jvit.VisionTransformer(jvit.vit_tiny_debug(image_size=448),
                                   remat=False)
    vit_p = {}
    for k, v in seen["vit"].items():
        node = vit_p
        *path, leaf = k.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(v)
    model = jagent.ContinuousLVLM(jagent.AgentConfig(
        llm=jllama_debug(lora_rank=acfg.llm.lora_rank,
                         lora_alpha=acfg.llm.lora_alpha, lora_dropout=0.0,
                         remat=False),
        lm_loss_scale=acfg.lm_loss_scale, rec_loss_scale=acfg.rec_loss_scale,
        add_patch_pos=acfg.add_patch_pos, vit_down=acfg.vit_down,
        vit_dim=acfg.vit_dim, num_img_in_tokens=acfg.num_img_in_tokens,
        num_img_out_tokens=acfg.num_img_out_tokens,
        resampler_heads=acfg.resampler_heads))
    batch = {k: jnp.asarray(v) for k, v in seen["batch"].items()}
    embeds = jax.jit(vit_j.apply)({"params": vit_p}, batch.pop("images"),
                                  batch["patch_positions"])
    batch["image_embeds"] = embeds
    out_j = jax.jit(model.apply)({"params": jax_tree(seen["agent"])},
                                 *[batch.get(k) for k in BATCH_KEYS])
    want = float(out_j["total_loss"])
    assert abs(got - want) <= LOSS_REL * abs(want), (got, want)
