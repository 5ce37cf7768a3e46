"""The port's SFT trainer against the JAX package's: schedule, trainable
partition, optimizer, and the agent's losses and gradients.

Inputs are numpy arrays from ``np.random.default_rng``; the JAX agent
takes them as its parameter tree, the port's through its state dict
(``tests/torch_train_fixtures.py``).  Attention runs the plain path on
both sides (XLA / the port's plain attention on the CPU).
"""

import dataclasses

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from seedx_tpu.train import schedule as jschedule
from seedx_tpu.train import trainer as jtrainer
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.train import partition as tpart
from seedx_tpu_torch.train import schedule as tschedule
from seedx_tpu_torch.train import trainer as ttrainer
from seedx_tpu_torch.utils.convert import from_jax_params, load_jax_params

from torch_train_fixtures import (close_rel, jax_tree, jax_value_and_grad,
                                  random_state, sft_batch, split_jax,
                                  tiny_agents, to_jax, to_torch)

torch.set_num_threads(1)

# fp32 on both sides: the agent's loss and grads agree to fp32 summation
# order; the stated tolerances are those of the bf16 training dtype
# (loss 1e-3 relative, each leaf's grads 2e-2 of its largest).  A leaf
# whose true gradient is zero (a key bias under softmax) is held to the
# largest gradient of the model instead: FLOOR of it.
LOSS_REL, GRAD_REL, FLOOR = 1e-3, 2e-2, 1e-4
# bf16 compute (fp32 masters cast at each use) on both sides, rounded at
# different points by XLA and ATen: 1e-2 on the loss, 5e-2 on each leaf's
# grads; the rounding noise is ~1% of the largest gradient, so a leaf is
# held to at least 1e-2 of that (the key biases' true gradient is zero)
BF16_LOSS_REL, BF16_GRAD_REL, BF16_FLOOR = 1e-2, 5e-2, 1e-2


@pytest.mark.parametrize("name", ["cosine", "constant",
                                  "constant_with_warmup", "linear"])
@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches_jax(name, warmup):
    kw = dict(learning_rate=1e-4, warmup_steps=warmup, total_steps=110,
              min_lr_ratio=0.05)
    want = jschedule.get_schedule(name, **kw)
    got = tschedule.get_schedule(name, **kw)
    for step in range(121):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5,
                                   atol=1e-12)


def test_trainable_set_matches_jax_path_labels():
    model, cfg_t = tiny_agents()
    agent = tagent.ContinuousLVLM(cfg_t)
    state = random_state(agent, 0)
    trainable_j, frozen_j = split_jax(jax_tree(state))
    labels = tpart.path_labels(agent.state_dict().keys())
    trainable_t, frozen_t = tpart.split_params(agent.state_dict(), labels)
    assert set(trainable_t) == set(from_jax_params(trainable_j))
    assert set(frozen_t) == set(from_jax_params(frozen_j))
    assert "llm.norm.scale" in trainable_t
    assert "llm.layers.q_proj.kernel" in frozen_t
    assert 0 < tpart.count_params(trainable_t) < tpart.count_params(
        agent.state_dict())


def test_optimizer_matches_optax_chain():
    """clip_by_global_norm + adamw written out, against the JAX package's
    optax chain on the same numpy params and grads (the clip active: the
    grads' norm is ~10), 3 updates, warmup 2 of a cosine schedule."""
    rng = np.random.default_rng(3)
    shapes = {"a": (7, 5), "b.c": (11,), "d": (2, 3, 4)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: 3.0 * rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    cfg_j = jtrainer.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                                 max_steps=10)
    cfg_t = ttrainer.TrainConfig(learning_rate=1e-2, warmup_steps=2,
                                 max_steps=10)
    tx, _ = jtrainer.make_optimizer(cfg_j)
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(p_j)
    state = ttrainer.TrainState(
        step=0, params={k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                        for k, v in params.items()},
        opt_state={m: {k: torch.zeros(s) for k, s in shapes.items()}
                   for m in ("mu", "nu")})
    schedule = ttrainer.make_schedule(cfg_t)
    for g in grads:
        norm_j = optax.global_norm(g)
        updates, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                 opt, p_j)
        p_j = optax.apply_updates(p_j, updates)
        norm_t = ttrainer.apply_updates(
            state, {k: torch.from_numpy(v) for k, v in g.items()}, cfg_t,
            schedule)
        np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
        assert float(norm_t) > cfg_t.max_grad_norm
        for k in shapes:
            np.testing.assert_allclose(state.params[k].detach().numpy(),
                                       np.asarray(p_j[k]), rtol=1e-6,
                                       atol=1e-7)
            # the update itself, relative to its size
            close_rel(state.params[k].detach().numpy() - params[k],
                      np.asarray(p_j[k]) - params[k], 1e-4)
    adam = opt[1][0]
    for k in shapes:      # the moments, relative to their largest
        close_rel(state.opt_state["mu"][k].numpy(), adam.mu[k], 1e-6)
        close_rel(state.opt_state["nu"][k].numpy(), adam.nu[k], 1e-6)
    assert state.step == 3


def _port_agent(cfg_t, state_np, train_cfg=None):
    agent = tagent.ContinuousLVLM(cfg_t)
    st = ttrainer.create_train_state(agent, train_cfg or
                                     ttrainer.TrainConfig())
    load_jax_params(agent, jax_tree(state_np))
    return agent, st


def _check_grads(grads_t, grads_j, rel, floor_rel):
    want = from_jax_params(grads_j)
    assert set(grads_t) == set(want)
    top = max(float(np.abs(v).max()) for v in want.values())
    for name, g in grads_t.items():
        close_rel(g.float().numpy(), want[name], rel, floor_rel * top)


@pytest.mark.parametrize("images", [True, False], ids=["images", "text"])
def test_agent_loss_and_grads_match_jax(images):
    model, cfg_t = tiny_agents()
    agent, st = _port_agent(cfg_t, random_state(tagent.ContinuousLVLM(cfg_t),
                                                1))
    state = {k: v.detach().float().numpy()
             for k, v in agent.state_dict().items()}
    trainable, frozen = split_jax(jax_tree(state))
    batch = sft_batch(2, images=images)
    (loss_j, out_j), grads_j = jax_value_and_grad(model)(
        trainable, frozen, to_jax(batch))
    grads_t, out_t = ttrainer.compute_grads(agent, st.params, to_torch(batch))
    for k in ttrainer.LOSS_KEYS:
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]),
                                   rtol=LOSS_REL, atol=1e-7)
    assert (float(out_t["rec_loss"]) > 0) == images
    _check_grads(grads_t, grads_j, GRAD_REL, FLOOR)


def test_agent_grads_with_accumulation_match_jax():
    """accum 2: the grads and losses of two micro-batches averaged, as the
    JAX train step's scan does."""
    model, cfg_t = tiny_agents()
    agent, st = _port_agent(cfg_t, random_state(tagent.ContinuousLVLM(cfg_t),
                                                4))
    state = {k: v.detach().float().numpy()
             for k, v in agent.state_dict().items()}
    trainable, frozen = split_jax(jax_tree(state))
    mbs = [sft_batch(5), sft_batch(6)]
    fn = jax_value_and_grad(model)
    outs = [fn(trainable, frozen, to_jax(b)) for b in mbs]
    grads_j = jax.tree.map(lambda a, b: (a + b) / 2, outs[0][1], outs[1][1])
    stacked = {k: np.stack([b[k] for b in mbs]) for k in mbs[0]}
    grads_t, out_t = ttrainer.compute_grads(agent, st.params,
                                            to_torch(stacked), accum=2)
    for k in ttrainer.LOSS_KEYS:
        want = (float(outs[0][0][1][k]) + float(outs[1][0][1][k])) / 2
        np.testing.assert_allclose(float(out_t[k]), want, rtol=LOSS_REL)
    _check_grads(grads_t, grads_j, GRAD_REL, FLOOR)


def test_agent_bf16_loss_and_grads_match_jax():
    """The training dtype: bf16 compute with fp32 trainable leaves (cast at
    each use) and bf16 frozen buffers on the port's side, the JAX
    package's bf16 compute over fp32 parameters on the other."""
    model, cfg_t = tiny_agents("bfloat16")
    state_np = random_state(tagent.ContinuousLVLM(cfg_t), 7)
    agent, st = _port_agent(cfg_t, state_np)
    assert all(p.dtype == torch.float32 for p in st.params.values())
    assert agent.llm.layers.q_proj.kernel.dtype == torch.bfloat16
    # JAX takes the frozen leaves as the port stores them (bf16 values)
    state = {k: v.detach().float().numpy()
             for k, v in agent.state_dict().items()}
    trainable, frozen = split_jax(jax_tree(state))
    batch = sft_batch(8)
    (_, out_j), grads_j = jax_value_and_grad(model)(trainable, frozen,
                                                     to_jax(batch))
    grads_t, out_t = ttrainer.compute_grads(agent, st.params, to_torch(batch))
    for k in ttrainer.LOSS_KEYS:
        np.testing.assert_allclose(float(out_t[k]), float(out_j[k]),
                                   rtol=BF16_LOSS_REL)
    _check_grads(grads_t, grads_j, BF16_GRAD_REL, BF16_FLOOR)


def _dropout_grads(cfg_t, state_np, remat, seed):
    cfg = dataclasses.replace(cfg_t, llm=dataclasses.replace(cfg_t.llm,
                                                             remat=remat))
    agent, st = _port_agent(cfg, state_np)
    gen = None
    if seed is not None:
        gen = torch.Generator().manual_seed(seed)
    grads, _ = ttrainer.compute_grads(agent, st.params,
                                      to_torch(sft_batch(9)), generator=gen)
    return grads


def test_lora_dropout_masks_survive_recomputation():
    """With dropout on, remat on and remat off give the same grads from
    the same generator: the recomputed layers draw the masks they drew in
    the forward.  Dropout changes the grads, and another seed other
    masks."""
    _, cfg_t = tiny_agents(lora_dropout=0.3)
    state_np = random_state(tagent.ContinuousLVLM(cfg_t), 10)
    remat = _dropout_grads(cfg_t, state_np, True, 123)
    plain = _dropout_grads(cfg_t, state_np, False, 123)
    for name, g in remat.items():
        close_rel(g.numpy(), plain[name].numpy(), 1e-6)
    lora = "llm.layers.q_proj.lora_a"
    for other in (_dropout_grads(cfg_t, state_np, True, None),
                  _dropout_grads(cfg_t, state_np, True, 124)):
        assert not torch.allclose(remat[lora], other[lora], rtol=1e-3)


def test_training_a_quantized_base_raises():
    _, cfg_t = tiny_agents()
    cfg = dataclasses.replace(cfg_t, llm=dataclasses.replace(
        cfg_t.llm, quantization="int8"))
    agent = tagent.ContinuousLVLM(cfg)
    st = ttrainer.create_train_state(agent, ttrainer.TrainConfig())
    with pytest.raises(ValueError, match="quantization"):
        ttrainer.compute_grads(agent, st.params, to_torch(sft_batch(1)))
