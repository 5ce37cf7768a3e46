"""The port's SFT loop: train steps against the JAX package's, exact resume,
checkpoints, metric writers, LoRA merge, and the data encoders and
collator against the JAX package's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.data import encoding as jenc
from seedx_tpu.data import pipeline as jpipe
from seedx_tpu.text.tokenizer import ByteFallbackTokenizer
from seedx_tpu.train import trainer as jtrainer
from seedx_tpu.utils.export import merge_lora as jmerge_lora
from seedx_tpu_torch.data import encoding as tenc
from seedx_tpu_torch.data import pipeline as tpipe
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.models.llama import llama_debug as tllama_debug
from seedx_tpu_torch.models.vit import ViTConfig, VisionTransformer
from seedx_tpu_torch.text.tokenizer import load_tokenizer
from seedx_tpu_torch.train import trainer as ttrainer
from seedx_tpu_torch.train.checkpoints import CheckpointManager
from seedx_tpu_torch.train.train_sft import RunConfig, train_loop
from seedx_tpu_torch.utils.convert import from_jax_params, load_jax_params
from seedx_tpu_torch.utils.export import merge_lora
from seedx_tpu_torch.utils.trackers import MetricWriters

from torch_train_fixtures import (close_rel, jax_tree, random_state,
                                  sft_batch, tiny_agents, to_jax, to_torch)

torch.set_num_threads(1)


def test_three_train_steps_match_jax():
    """Per-step losses (and grad norm, lr) of 3 steps on one batch: the
    port's train step against the JAX package's jitted one (fp32 both
    sides: the stated tolerance 1e-2 for every metric, and 1e-5 on the
    total loss, which fp32 on both sides meets)."""
    model, cfg_t = tiny_agents()
    agent = tagent.ContinuousLVLM(cfg_t)
    kw = dict(learning_rate=1e-3, warmup_steps=0, max_steps=10)
    st = ttrainer.create_train_state(agent, ttrainer.TrainConfig(**kw))
    load_jax_params(agent, jax_tree(random_state(agent, 12)))
    state_j, frozen = jtrainer.create_train_state(
        jax_tree({k: v.detach().numpy()
                  for k, v in agent.state_dict().items()}),
        jtrainer.TrainConfig(**kw))
    step_j = jtrainer.make_train_step(model, jtrainer.TrainConfig(**kw))
    step_t = ttrainer.make_train_step(agent, ttrainer.TrainConfig(**kw))
    batch = sft_batch(13)
    for i in range(3):
        state_j, m_j = step_j(state_j, frozen, to_jax(batch),
                              jax.random.PRNGKey(i))
        m_t = step_t(st, to_torch(batch))
        for k in ("total_loss", "lm_loss", "rec_loss", "grad_norm", "lr"):
            np.testing.assert_allclose(m_t[k], float(m_j[k]), rtol=1e-2)
        np.testing.assert_allclose(m_t["total_loss"],
                                   float(m_j["total_loss"]), rtol=1e-5)
    assert st.step == 3 and int(state_j.step) == 3


def _tiny_stack(seed=0):
    """A tiny ViT (4 queries of width 32) and an agent taking 4-token
    image spans, with LoRA dropout on; random weights from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    vit = init_normal_(VisionTransformer(ViTConfig(
        image_size=28, patch_size=14, width=32, layers=1, heads=2,
        mlp_ratio=2.0, n_queries=4, output_dim=32, pos_embed_len=4,
        dtype=torch.float32)), gen)
    llm = tllama_debug(hidden_size=64, intermediate_size=128, num_layers=2,
                       num_heads=2, num_kv_heads=2, lora_rank=4,
                       lora_dropout=0.1, vocab_size=512, dtype=torch.float32)
    agent = init_normal_(tagent.ContinuousLVLM(tagent.AgentConfig(
        llm=llm, vit_dim=32, resampler_heads=2, num_img_in_tokens=4,
        num_img_out_tokens=4, vit_down=False, dtype=torch.float32)), gen)
    return vit, agent


def _image_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b, s = 2, 24
        ids = rng.integers(3, 500, (b, s)).astype(np.int32)
        am = np.ones((b, s), np.int32)
        am[1, 18:] = 0
        gen = np.zeros((b, s), bool)
        gen[1, 10:14] = True
        cmp_ = np.zeros((b, s), bool)
        cmp_[0, 2:6] = True
        out.append(dict(
            input_ids=ids, attention_mask=am,
            labels=np.where(am > 0, ids, -100).astype(np.int32),
            images=rng.standard_normal((2, 28, 28, 3)).astype(np.float32),
            embeds_gen_mask=np.array([False, True]),
            embeds_cmp_mask=np.array([True, False]), ids_gen_mask=gen,
            ids_cmp_mask=cmp_,
            patch_positions=np.full((2, 2), 0.5, np.float32)))
    return out


def _losses(output_dir):
    with open(os.path.join(output_dir, "metrics.jsonl")) as f:
        return {r["step"]: r["total_loss"] for r in map(json.loads, f)}


@pytest.mark.parametrize("accum", [1, 2])
def test_train_loop_resume_equals_straight_run(tmp_path, accum):
    """A run cut after 3 steps (its data ends), then resumed to 5, equals
    5 straight steps bit for bit (trainable leaves, optimizer state,
    per-step losses), dropout on."""
    batches = _image_batches(12)
    cfg = ttrainer.TrainConfig(learning_rate=1e-3, warmup_steps=1,
                               max_steps=5, gradient_accumulation_steps=accum)
    run = dict(log_steps=1, trackers=("jsonl",), seed=3)

    def run_on(data, out, resume):
        vit, agent = _tiny_stack()
        return train_loop(agent, vit, iter(data), cfg,
                          RunConfig(output_dir=str(out), resume=resume,
                                    **run), device="cpu")

    run_on(batches[:3 * accum], tmp_path / "a", False)
    ckpts = sorted(os.listdir(tmp_path / "a" / "checkpoints"))
    assert ckpts == ["checkpoint-3"]
    resumed = run_on(batches, tmp_path / "a", True)
    straight = run_on(batches, tmp_path / "b", False)
    assert resumed.step == straight.step == 5
    for n, p in straight.params.items():
        assert torch.equal(resumed.params[n], p), n
        for m in ("mu", "nu"):
            assert torch.equal(resumed.opt_state[m][n],
                               straight.opt_state[m][n]), (m, n)
    la, lb = _losses(tmp_path / "a"), _losses(tmp_path / "b")
    assert sorted(la) == sorted(lb) == [0, 1, 2, 3, 4]
    assert la == lb
    assert sorted(os.listdir(tmp_path / "b" / "checkpoints")) == [
        "checkpoint-5"]


def test_checkpoint_manager_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    states = {s: {"step": s, "trainable": {"w": torch.full((3,), float(s))},
                  "opt_state": {"mu": {"w": torch.zeros(3)}}}
              for s in (1, 2, 3)}
    for s, st in states.items():
        mgr.save(s, st)
    assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
    back = mgr.restore()
    assert back["step"] == 3
    assert torch.equal(back["trainable"]["w"], states[3]["trainable"]["w"])
    assert mgr.restore(2)["step"] == 2
    assert not any(n.endswith(".tmp") for n in os.listdir(mgr.directory))


def test_metric_writers_jsonl(tmp_path):
    with MetricWriters(str(tmp_path), trackers=("jsonl",)) as w:
        w.log({"total_loss": 1.5, "lr": 1e-4}, 0)
        w.log({"total_loss": 1.25, "lr": 9e-5}, 1)
    rows = [json.loads(x) for x in open(tmp_path / "metrics.jsonl")]
    assert rows == [{"total_loss": 1.5, "lr": 1e-4, "step": 0},
                    {"total_loss": 1.25, "lr": 9e-5, "step": 1}]


def test_merge_lora_matches_jax_and_keeps_logits():
    """The port's merge against the JAX package's on the same weights;
    then the merged lora_rank=0 agent gives the unmerged agent's logits."""
    _, cfg_t = tiny_agents()
    agent = tagent.ContinuousLVLM(cfg_t).eval()
    state_np = random_state(agent, 14)
    load_jax_params(agent, jax_tree(state_np))
    merged_j = from_jax_params(jmerge_lora(jax.tree.map(
        np.asarray, jax_tree(state_np)), alpha=cfg_t.llm.lora_alpha))
    merged_t = merge_lora(agent.state_dict(), alpha=cfg_t.llm.lora_alpha)
    assert set(merged_t) == set(merged_j)
    assert not any(k.endswith((".lora_a", ".lora_b")) for k in merged_t)
    for k, v in merged_t.items():
        close_rel(v.numpy(), merged_j[k], 1e-6)
    plain = tagent.ContinuousLVLM(dataclasses.replace(
        cfg_t, llm=dataclasses.replace(cfg_t.llm, lora_rank=0))).eval()
    plain.load_state_dict(merged_t)
    ids = torch.from_numpy(np.random.default_rng(15).integers(
        3, 32000, (2, 40)))
    pos = torch.arange(40)[None].expand(2, -1)
    with torch.no_grad():
        want = agent.llm_step(agent.embed_ids(ids), pos)[0]
        got = plain.llm_step(plain.embed_ids(ids), pos)[0]
    close_rel(got.numpy(), want.numpy(), 1e-5)


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), k)


CONVERSATION = ["What is in the picture?", "A red bicycle by a lake.",
                "And the weather?", "Sunny, with a few clouds."]


@pytest.mark.parametrize("patch_length", [0, 3, 5])
def test_encode_conversation_matches_jax(patch_length):
    for seed in range(3):
        kw = dict(max_length=880, patch_length=patch_length)
        want = jenc.encode_conversation_sample(
            CONVERSATION, ByteFallbackTokenizer(),
            rng=np.random.default_rng(seed), **kw)
        got = tenc.encode_conversation_sample(
            CONVERSATION, load_tokenizer(), rng=np.random.default_rng(seed),
            **kw)
        _assert_same(got, want)
    # an image span past max_length drops the sample, as the JAX encoder
    assert tenc.encode_conversation_sample(
        CONVERSATION, load_tokenizer(), max_length=200, patch_length=5,
        rng=np.random.default_rng(0)) is None


@pytest.mark.parametrize("img_first_ratio,add_gen_prompt",
                         [(0.0, False), (0.0, True), (1.0, False),
                          (0.5, False)])
def test_encode_caption_matches_jax(img_first_ratio, add_gen_prompt):
    for seed in range(3):
        kw = dict(max_length=260, img_first_ratio=img_first_ratio,
                  add_gen_prompt=add_gen_prompt, patch_length=1)
        want = jenc.encode_caption_sample(
            "a red bicycle by a lake", ByteFallbackTokenizer(),
            rng=np.random.default_rng(seed), **kw)
        got = tenc.encode_caption_sample(
            "a red bicycle by a lake", load_tokenizer(),
            rng=np.random.default_rng(seed), **kw)
        _assert_same(got, want)


def test_collate_and_batching_match_jax():
    tok = load_tokenizer()
    rng = np.random.default_rng(4)
    samples = []
    for i, n in enumerate((3, 1, 5)):
        s = tenc.encode_conversation_sample(
            CONVERSATION, tok, max_length=880, patch_length=n,
            rng=np.random.default_rng(i))
        s["images"] = rng.random((n, 28, 28, 3)).astype(np.float32)
        s["patch_positions"] = rng.random((n, 2)).astype(np.float32)
        samples.append(s)
    text_only = tenc.encode_caption_sample("text", tok, max_length=880,
                                           img_first_ratio=1.0,
                                           rng=np.random.default_rng(9))
    del text_only["embeds_gen_mask"], text_only["embeds_cmp_mask"]
    samples.append(text_only)
    groups_t = list(tpipe.batched(iter(samples), 2))
    groups_j = list(jpipe.batched(iter(samples), 2))
    assert len(groups_t) == len(groups_j) == 2
    for gt, gj in zip(groups_t, groups_j):
        _assert_same(tpipe.collate_anyres(gt, max_images=8, image_size=28),
                     jpipe.collate_anyres(gj, max_images=8, image_size=28))
    with pytest.raises(ValueError, match="max_images"):
        tpipe.collate_anyres(samples[:3], max_images=4, image_size=28)
    it = tpipe.ResumableIterator(iter(range(10)))
    assert it.skip(4) == 4 and next(it) == 4 and it.position == 5
    assert it.skip(10) == 5
