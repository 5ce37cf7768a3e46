"""The port's de-tokenizer (adapter) training against the JAX package's
(seedx_tpu/train/train_adapter.py): the sigma table, the trainable sets,
the diffusion loss and its gradients, one optimizer update, and the loop.

Weights: the JAX debug UNet's and a small ResamplerXL's parameter trees
(the shapes of ``init`` through ``jax.eval_shape``, every float leaf
redrawn from ``np.random.default_rng``), loaded into the port through
``utils/convert.py``.  fp32 on both sides, so the comparison is of the
algorithm; the stated tolerances are those of the SFT trainer's tests:
the loss 1e-3 relative, each leaf's gradients 2e-2 of its largest (or of
``FLOOR`` times the largest of all, for a leaf whose true gradient is
near zero).
"""


import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from seedx_tpu.models import detokenizer as jdet
from seedx_tpu.models.adapter import (ADAPTER_TRAINABLE_PATTERNS as
                                      J_PATTERNS)
from seedx_tpu.models.sdxl import unet as junet
from seedx_tpu.models.sdxl.pipeline import SamplerConfig as JSampler
from seedx_tpu.models.sdxl.pipeline import default_time_ids as j_time_ids
from seedx_tpu.train import train_adapter as jtrain
from seedx_tpu.train.partition import path_labels as j_path_labels
from seedx_tpu.train.schedule import get_schedule as j_schedule
from seedx_tpu_torch.models import detokenizer as tdet
from seedx_tpu_torch.models.adapter import ADAPTER_TRAINABLE_PATTERNS
from seedx_tpu_torch.models.layers import init_normal_
from seedx_tpu_torch.models.sdxl import unet as tunet
from seedx_tpu_torch.models.sdxl.pipeline import SamplerConfig
from seedx_tpu_torch.models.sdxl.pipeline import default_time_ids
from seedx_tpu_torch.train import train_adapter as ttrain
from seedx_tpu_torch.train.trainer import apply_updates
from seedx_tpu_torch.utils.convert import from_jax_params, load_jax_params
from test_torch_models import randomize
from torch_train_fixtures import close_rel

torch.set_num_threads(1)

LOSS_REL, GRAD_REL, FLOOR = 1e-3, 2e-2, 1e-4
B, HW, T = 2, 8, 4


def _cfgs(jdtype=jnp.float32, tdtype=torch.float32):
    """The debug UNet and the ResamplerXL of tests/test_adapter_train.py,
    JAX and port."""
    ucfg_j = junet.sdxl_debug_unet(dtype=jdtype)
    ucfg_t = tunet.sdxl_debug_unet(dtype=tdtype)
    out2 = (ucfg_j.projection_class_embeddings_input_dim
            - 6 * ucfg_j.addition_time_embed_dim)
    kw = dict(dim=64, depth=1, dim_head=16, heads=4, num_queries=8,
              embedding_dim=32, output2_dim=out2,
              output1_dim=ucfg_j.cross_attention_dim - out2, ff_mult=2)
    return (ucfg_j, jdet.DetokenizerConfig(dtype=jdtype, **kw), ucfg_t,
            tdet.DetokenizerConfig(dtype=tdtype, **kw))


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return {"latents": rng.standard_normal((B, HW, HW, 4)).astype(
                np.float32),
            "image_embeds": rng.standard_normal((B, T, 32)).astype(
                np.float32)}


@pytest.fixture(scope="module")
def pair():
    """(JAX modules and params, port modules) on the same weights."""
    ucfg_j, rcfg_j, ucfg_t, rcfg_t = _cfgs()
    unet_j, res_j = junet.UNet2DCondition(ucfg_j), jdet.ResamplerXL(rcfg_j)
    x = _inputs()
    res_shapes = jax.eval_shape(res_j.init, jax.random.PRNGKey(0),
                                jnp.asarray(x["image_embeds"]))["params"]
    res_p = randomize(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                   nn.meta.unbox(res_shapes)), 1)
    prompt = jnp.zeros((B, 8, ucfg_j.cross_attention_dim))
    pooled = jnp.zeros((B, rcfg_j.output2_dim))
    unet_shapes = jax.eval_shape(
        unet_j.init, jax.random.PRNGKey(0), jnp.asarray(x["latents"]),
        jnp.ones((B,)), prompt, pooled, jnp.zeros((B, 6)))["params"]
    unet_p = randomize(jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                                    nn.meta.unbox(unet_shapes)), 2)
    unet_t = load_jax_params(tunet.UNet2DCondition(ucfg_t), unet_p)
    res_t = load_jax_params(tdet.ResamplerXL(rcfg_t), res_p)
    return (unet_j, res_j, {"unet": unet_p, "resampler": res_p}), \
        (unet_t, res_t)


def _port_name(jax_name: str, port_names) -> str:
    """A JAX leaf's port state name: the flatten of utils/convert.py, and a
    conv ``kernel`` read as the torch-layout ``weight``."""
    name = next(iter(from_jax_params(_nest(jax_name))))
    if name not in port_names and name.endswith(".kernel"):
        name = name[:-len("kernel")] + "weight"
    assert name in port_names, name
    return name


def _nest(path: str) -> dict:
    tree = node = {}
    *parts, leaf = path.split("/")
    for p in parts:
        node = node.setdefault(p, {})
    node[leaf] = np.zeros(())
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


def _jax_leaf_as_port(name: str, value) -> np.ndarray:
    """A JAX gradient / leaf in the port's layout (conv kernels
    [kh, kw, in, out] -> [out, in, kh, kw])."""
    v = np.asarray(value, np.float32)
    return v.transpose(3, 2, 0, 1) if name.endswith(".weight") else v


def test_sigma_tables_bit_equal_jax():
    got = ttrain.make_sigma_tables()
    want = np.asarray(jtrain.make_sigma_tables())
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got[0]) < float(got[-1])


@pytest.mark.parametrize("full_ft", [False, True])
def test_trainable_set_matches_jax_path_labels(pair, full_ft):
    """The leaves ``init_state`` makes trainable are the JAX package's
    ``path_labels`` under ADAPTER_TRAINABLE_PATTERNS (or ``.*`` with
    ``full_ft``), leaf for leaf."""
    (_, _, params_j), _ = pair
    _, _, ucfg_t, rcfg_t = _cfgs()
    unet_t = tunet.UNet2DCondition(ucfg_t)
    res_t = tdet.ResamplerXL(rcfg_t)
    names = set(unet_t.state_dict(prefix="unet.")) | set(
        res_t.state_dict(prefix="resampler."))
    labels = _flat(j_path_labels(params_j, (r".*",) if full_ft
                                 else J_PATTERNS))
    want = {_port_name(k, names) for k, lab in labels.items()
            if lab == "trainable"}
    assert len(labels) == len(names)
    init_state, _ = ttrain.make_adapter_train_step(
        unet_t, res_t, ttrain.AdapterTrainConfig(full_ft=full_ft),
        torch.zeros(6))
    got = set(init_state().params)
    assert got == want
    if full_ft:
        assert got == names
    else:
        assert "unet.conv_in.weight" in got and "resampler.latents" in got
        assert not any(n.startswith("unet.") and (
            "ff_out" in n or ".to_q." in n) for n in got)
    assert ttrain.AdapterTrainConfig().trainable_patterns == \
        ADAPTER_TRAINABLE_PATTERNS


def test_adapter_loss_and_grads_match_jax(pair):
    """``adapter_loss`` and the trainable leaves' gradients against a JAX
    ``value_and_grad`` of the loss of seedx_tpu/train/train_adapter.py:
    74-96, t and the noise drawn as its lines 74-79 draw them and handed
    to the port."""
    (unet_j, res_j, params_j), (unet_t, res_t) = pair
    x = _inputs()
    tids_j = j_time_ids(JSampler(height=HW * 8, width=HW * 8), 1)[0]
    sigmas = jtrain.make_sigma_tables()
    rng = jax.random.PRNGKey(7)
    t_rng, n_rng = jax.random.split(rng)
    t = jax.random.randint(t_rng, (B,), 0, sigmas.shape[0])
    noise = jax.random.normal(n_rng, x["latents"].shape, jnp.float32)

    labels = j_path_labels(params_j, J_PATTERNS)
    flat_p, flat_l = _flat(params_j), _flat(labels)
    trainable = {k: v for k, v in flat_p.items()
                 if flat_l[k] == "trainable"}
    frozen = {k: v for k, v in flat_p.items() if flat_l[k] == "frozen"}

    def unflat(flat):
        tree = {}
        for k, v in flat.items():
            node = tree
            *parts, leaf = k.split("/")
            for p in parts:
                node = node.setdefault(p, {})
            node[leaf] = v
        return tree

    def loss_fn(tr, batch):
        params = unflat({**frozen, **tr})
        sigma = sigmas[t][:, None, None, None]
        noisy = batch["latents"] + noise * sigma
        scaled = noisy / jnp.sqrt(sigma ** 2 + 1.0)
        prompt, pooled = res_j.apply({"params": params["resampler"]},
                                     batch["image_embeds"])
        eps = unet_j.apply({"params": params["unet"]}, scaled,
                           t.astype(jnp.float32), prompt, pooled,
                           jnp.broadcast_to(tids_j, (B, 6)))
        return jnp.mean((eps.astype(jnp.float32)
                         - noise.astype(jnp.float32)) ** 2)

    loss_j, grads_j = jax.jit(jax.value_and_grad(loss_fn))(
        {k: jnp.asarray(v) for k, v in trainable.items()},
        {k: jnp.asarray(v) for k, v in x.items()})

    init_state, _ = ttrain.make_adapter_train_step(
        unet_t, res_t, ttrain.AdapterTrainConfig(), torch.zeros(6))
    state = init_state()
    tids_t = default_time_ids(SamplerConfig(height=HW * 8, width=HW * 8),
                              1)[0]
    loss_t = ttrain.adapter_loss(
        unet_t, res_t, {k: torch.from_numpy(v) for k, v in x.items()},
        torch.from_numpy(np.asarray(t)).long(),
        torch.from_numpy(np.asarray(noise)), ttrain.make_sigma_tables(),
        tids_t)
    loss_t.backward()
    assert abs(float(loss_t) - float(loss_j)) <= \
        LOSS_REL * abs(float(loss_j)), (float(loss_t), float(loss_j))
    names = set(state.params)
    # (the debug config's unet_proj_1 is 0 wide: its leaf has no elements)
    top = max(float(np.abs(np.asarray(g)).max()) for g in grads_j.values()
              if np.size(g))
    assert len(grads_j) == len(names)
    for k, g in grads_j.items():
        name = _port_name(k, names)
        want = _jax_leaf_as_port(name, g)
        got = state.params[name].grad.numpy()
        assert got.shape == want.shape, name
        if want.size:
            close_rel(got, want, GRAD_REL, floor=FLOOR * top / GRAD_REL)


def test_optimizer_step_matches_optax():
    """One update of the adapter's optimizer (clip 1.0, AdamW at optax's
    defaults and weight decay 0.01, the cosine schedule) against the optax
    chain make_adapter_train_step builds, on the same numpy leaves and
    grads (the clip active): leaves to 1e-6."""
    rng = np.random.default_rng(3)
    shapes = {"unet.conv_in.weight": (8, 4, 3, 3), "resampler.latents":
              (1, 8, 64), "unet.x.to_k.kernel": (32, 64)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = {k: 3.0 * rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    cfg = ttrain.AdapterTrainConfig(learning_rate=1e-2, warmup_steps=2,
                                    max_steps=10)
    schedule = j_schedule("cosine", cfg.learning_rate, cfg.warmup_steps,
                          cfg.max_steps, cfg.min_lr_ratio)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adamw(schedule, weight_decay=cfg.weight_decay))
    p_j = {k: jnp.asarray(v) for k, v in params.items()}
    opt = tx.init(p_j)
    state = ttrain.TrainState(
        step=0, params={k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                        for k, v in params.items()},
        opt_state={m: {k: torch.zeros(s) for k, s in shapes.items()}
                   for m in ("mu", "nu")})
    t_schedule = ttrain.get_schedule("cosine", cfg.learning_rate,
                                     cfg.warmup_steps, cfg.max_steps,
                                     cfg.min_lr_ratio)
    for _ in range(3):     # the first update is at lr 0 (warmup)
        updates, opt = tx.update({k: jnp.asarray(v)
                                  for k, v in grads.items()}, opt, p_j)
        p_j = optax.apply_updates(p_j, updates)
        norm = apply_updates(state, {k: torch.from_numpy(v)
                                     for k, v in grads.items()}, cfg,
                             t_schedule)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(grads)),
                                   rtol=1e-6)
        for k in shapes:
            np.testing.assert_allclose(state.params[k].detach().numpy(),
                                       np.asarray(p_j[k]), rtol=1e-6,
                                       atol=1e-7)
            close_rel(state.params[k].detach().numpy() - params[k],
                      np.asarray(p_j[k]) - params[k], 1e-4)


def _bf16_stack(seed=0):
    _, _, ucfg_t, rcfg_t = _cfgs(jnp.bfloat16, torch.bfloat16)
    gen = torch.Generator().manual_seed(seed)
    return (init_normal_(tunet.UNet2DCondition(ucfg_t).eval(), gen),
            init_normal_(tdet.ResamplerXL(rcfg_t).eval(), gen))


def _frozen_copy(*modules):
    return {f"{i}.{n}": t.clone() for i, m in enumerate(modules)
            for n, t in m.named_buffers()}


def test_eight_steps_lower_the_loss_frozen_bits_kept():
    """The bf16 debug stack, as tests/test_adapter_train.py runs the JAX
    step: 8 steps on one batch, the generator reseeded with i % 2, the
    loss finite and lower on a repeated draw; every frozen leaf keeps its
    bits, and the trainable set is the base patterns'."""
    unet, res = _bf16_stack()
    x = {k: torch.from_numpy(v) for k, v in _inputs(5).items()}
    tids = default_time_ids(SamplerConfig(height=HW * 8, width=HW * 8),
                            1)[0]
    init_state, train_step = ttrain.make_adapter_train_step(
        unet, res, ttrain.AdapterTrainConfig(learning_rate=1e-3,
                                             warmup_steps=0, max_steps=50),
        tids)
    state = init_state()
    assert any(n.startswith("resampler.") for n in state.params)
    assert any("to_k" in n for n in state.params)
    assert not any("ff_out" in n for n in state.params)
    frozen = _frozen_copy(unet, res)
    losses = []
    for i in range(8):
        m = train_step(state, x, torch.Generator().manual_seed(i % 2))
        losses.append(m["total_loss"])
        assert np.isfinite(losses[-1])
    assert losses[-1] < losses[0] or losses[-2] < losses[1]
    assert state.step == 8
    after = _frozen_copy(unet, res)
    assert after.keys() == frozen.keys()
    for n, t in frozen.items():
        assert torch.equal(after[n], t), n


def test_set_trainable_keeps_bf16_inference_bits():
    """The bf16 UNet's eps is the same bit for bit before and after its
    trainable leaves become fp32 masters (cast back at each use)."""
    unet, res = _bf16_stack(1)
    rng = np.random.default_rng(6)
    ucfg = unet.cfg
    args = (torch.from_numpy(rng.standard_normal((B, HW, HW, 4)).astype(
                np.float32)),
            torch.tensor([981.0, 21.0]),
            torch.from_numpy(rng.standard_normal(
                (B, 8, ucfg.cross_attention_dim)).astype(np.float32)),
            torch.from_numpy(rng.standard_normal(
                (B, res.cfg.output2_dim)).astype(np.float32)),
            default_time_ids(SamplerConfig(height=HW * 8, width=HW * 8), B))
    with torch.no_grad():
        before = unet(*args)
        res_before = res(torch.from_numpy(_inputs(7)["image_embeds"]))
    init_state, _ = ttrain.make_adapter_train_step(
        unet, res, ttrain.AdapterTrainConfig(), torch.zeros(6))
    state = init_state()
    assert state.params["unet.conv_in.weight"].dtype == torch.float32
    with torch.no_grad():
        after = unet(*args)
        res_after = res(torch.from_numpy(_inputs(7)["image_embeds"]))
    assert after.dtype == torch.bfloat16
    assert torch.equal(before, after)
    for a, b in zip(res_before, res_after):
        assert torch.equal(a, b)
