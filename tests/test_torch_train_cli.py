"""The port's SFT entry point, ``seedx_tpu_torch.train.train_sft.main``:
the JAX package's CLI over the repo's YAML configs and the file
datapipes, on the debug models (``SEEDX_DEBUG=1``) on the CPU.

  * both repo data YAMLs (only their paths rewritten to synthetic files)
    train for 2 steps, save, and resume to a third;
  * every YAML under ``configs/`` resolves to a target of the port
    (``seedx_tpu.`` read as ``seedx_tpu_torch.``), the mesh layouts of
    ``configs/parallel/`` to the port's ``create_mesh``;
  * ``--parallel`` raises: training on a mesh is not ported yet;
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

from torch_data_fixtures import REPO, data_yamls
from torch_train_fixtures import BATCH_KEYS, jax_tree

torch.set_num_threads(2)

CONFIGS = {k: os.path.join(REPO, "configs", v) for k, v in (
    ("image_transform", "processer/qwen_448_transform.yaml"),
    ("tokenizer", "tokenizer/clm_llama_tokenizer_224loc_anyres.yaml"),
    ("visual_encoder", "visual_encoder/qwen_vitg_448.yaml"),
    ("agent_model", "clm_models/agent_seed_x.yaml"))}
LOSS_REL = 1e-3


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


def test_parallel_flag_raises(tmp_path):
    with pytest.raises(NotImplementedError,
                       match="multi-device training on a mesh .* is not "
                             "ported yet"):
        train_sft.main(_argv("unused.yaml", tmp_path, "--parallel",
                             os.path.join(REPO, "configs/parallel/"
                                          "fsdp.yaml")))


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
