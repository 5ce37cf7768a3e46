"""The port on a device mesh (``seedx_tpu_torch/parallel``,
``SeedXRuntime.shard``) against the JAX package (the cases of
tests/test_sharding.py).

Multi-rank cases run gloo process groups on the CPU: the parent runs JAX,
writes the weights and inputs as ``.npz`` and starts the ranks of
``tests/test_torch_shard_worker.py`` (torch and the port only), which meet
through a ``FileStore`` under ``tmp_path`` (no ports to race for under
xdist); each run is joined with a timeout and its ranks killed past it, so
a stuck collective fails the test instead of hanging the suite.  At most
4 ranks a run.

Float32 on both sides.  Tolerances: the mesh's logits within 2e-5 of their
scale (the LLaMA parity tolerance of tests/test_torch_models.py: a
row-parallel sum only reorders fp32 additions); the SFT loss within 1e-5
relative; tokens equal; the denoise at JAX's own ``atol=2e-2``
(tests/test_sharding.py); int4 at tensor 2 within 1e-5 of the unsharded
port (the whole-row int8 scale makes the shards' codes the unsharded
ones), where the local-absmax mutant must miss by more.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
from flax import linen as nn

import seedx_tpu.ops.int4_matmul
from seedx_tpu.inference import apps as japps
from seedx_tpu.inference.continuous import ContinuousEngine
from seedx_tpu.models import llama as jllama
from seedx_tpu.models import resampler as jres
from seedx_tpu.models import vit as jvit
from seedx_tpu.models import agent as jagent
from seedx_tpu.parallel import mesh as jmesh
from seedx_tpu.text import prompts as jprompts
from seedx_tpu.utils.quantize import quantize_llama_params
from seedx_tpu_torch.models import agent as tagent
from seedx_tpu_torch.models import llama as tllama
from seedx_tpu_torch.models import resampler as tres
from seedx_tpu_torch.models import vit as tvit
from seedx_tpu_torch.ops import int4_matmul as tint4
from seedx_tpu_torch.parallel import distributed as tdist
from seedx_tpu_torch.parallel import mesh as tmesh
from seedx_tpu_torch.utils.convert import from_jax_params
from seedx_tpu_torch.utils.quantize import quantize_kernel_int4

from test_torch_image_out import _jax_runtime
from test_torch_models import randomize

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "test_torch_shard_worker.py")
RUN_TIMEOUT = 240      # seconds a multi-rank run may take


def _flat(prefix, tree):
    out = {}
    for path, v in jax.tree_util.tree_leaves_with_path(
            nn.meta.unbox(tree)):
        key = "/".join(str(getattr(p, "key", p)) for p in path)
        out[f"{prefix}/{key}"] = np.asarray(v)
    return out


def _start(scenario, world, root, inputs, name=None):
    """Start ``world`` ranks of ``scenario`` in ``root/name`` (default: the
    scenario's name)."""
    d = root / (name or scenario)
    d.mkdir()
    np.savez(d / "in.npz", **inputs)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, WORKER, scenario, str(r), str(world), str(d)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    return procs, d


def _join(run, timeout=RUN_TIMEOUT):
    """Every rank's outputs; kills the run past ``timeout``."""
    procs, d = run
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        pytest.fail(f"{d.name}: ranks still running after {timeout} s")
    bad = [(r, p.stdout.read().decode()[-3000:])
           for r, p in enumerate(procs) if p.returncode != 0]
    for p in procs:
        p.stdout.close()
    assert not bad, bad[0]
    return [dict(np.load(d / f"out{r}.npz")) for r in range(len(procs))]


def _close(actual, expected, rel):
    expected = np.asarray(expected, np.float32)
    np.testing.assert_allclose(np.asarray(actual, np.float32), expected,
                               rtol=0, atol=rel * np.abs(expected).max())


def _image():
    rng = np.random.RandomState(3)
    return rng.randint(0, 255, (60, 60, 3)).astype(np.uint8)


def _requests(tok):
    t2i = jprompts.generation_prompt("a red boat")
    ids1 = [tok.bos_token_id] + tok.encode(t2i)
    ids2 = [tok.bos_token_id] + tok.encode("hi there")
    return [ids1, ids2, ids2 + ids2[1:]]


def _sft_inputs(rt_j):
    b, s, n, t = 2, 300, 2, 256
    rng = np.random.default_rng(11)
    ids = rng.integers(0, 300, (b, s)).astype(np.int32)
    attn = np.ones((b, s), bool)
    ids_cmp = np.zeros((b, s), bool)
    ids_cmp[0, 1:65] = True
    ids_gen = np.zeros((b, s), bool)
    ids_gen[1, 2:2 + t] = True
    return {"input_ids": ids, "attention_mask": attn,
            "labels": np.where(attn, ids, -100),
            "image_embeds": (0.5 * rng.standard_normal((n, t, 64))).astype(
                np.float32),
            "embeds_gen_mask": np.array([False, True]),
            "embeds_cmp_mask": np.array([True, False]),
            "ids_gen_mask": ids_gen, "ids_cmp_mask": ids_cmp,
            "patch_positions": np.full((n, 2), 0.5, np.float32)}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The debug runtime (JAX's weights) on a (1, 2, 2) mesh of 4 gloo
    ranks, and the JAX package's results for the same inputs (computed
    while the ranks run)."""
    rt_j = _jax_runtime()
    ad = rt_j.adapter
    ids = np.random.default_rng(12).integers(3, 500, (2, 12))
    sft = _sft_inputs(rt_j)
    h, w = ad.cfg.sampler.latent_hw
    noise = np.array(jax.random.normal(jax.random.PRNGKey(42),
                                       (1, h, w, ad.cfg.sampler.
                                        latent_channels)))
    inputs = {"mesh": np.array([1, 2, 2]), "ids": ids, "image": _image(),
              "noise": noise,
              "requests": np.array(json.dumps(_requests(rt_j.tokenizer))),
              **{f"sft_{k}": v for k, v in sft.items()}}
    for key, tree in (("vit", rt_j.vit_params), ("agent", rt_j.agent_params),
                      ("unet", ad.unet_params),
                      ("resampler", ad.resampler_params),
                      ("vae_decoder", ad.vae_decoder_params),
                      ("vae_encoder", ad.vae_encoder_params)):
        inputs.update(_flat(key, tree))
    run = _start("runtime", 4, tmp_path_factory.mktemp("mesh"), inputs)

    want = {}
    agent, params = rt_j.agent, {"params": rt_j.agent_params}
    emb = agent.apply(params, jnp.asarray(ids), method=lambda m, i:
                      m.llm.embed(i))
    pos = jnp.broadcast_to(jnp.arange(ids.shape[1]), ids.shape)
    want["logits"] = np.asarray(agent.apply(
        params, emb, pos, method=lambda m, e, p: m.llm(e, p))[0])
    want["total_loss"] = float(agent.apply(params, *(
        jnp.asarray(sft[k]) for k in (
            "input_ids", "attention_mask", "labels", "image_embeds",
            "embeds_gen_mask", "embeds_cmp_mask", "ids_gen_mask",
            "ids_cmp_mask", "patch_positions")))["total_loss"])
    image = Image.fromarray(_image())
    want["comprehend"] = list(japps.comprehend(rt_j, image, "what?",
                                               max_new_tokens=4)["tokens"])
    eng = ContinuousEngine(rt_j, slots=2, max_new_tokens=6, chunk_steps=3,
                           prompt_buckets=(64,))
    base = {"image_embeds": None, "embeds_cmp_mask": None,
            "ids_cmp_mask": None, "patch_positions": None}
    rids = [eng.submit(dict(base, input_ids=r))
            for r in _requests(rt_j.tokenizer)]
    res = eng.run()
    want["engine"] = [res[i] for i in rids]
    want["denoise"] = np.asarray(ad.generate(rt_j.encode_image_single(image),
                                             from_vit=True,
                                             num_inference_steps=3))
    return rt_j, want, _join(run)


def test_mesh_shape_and_errors_match_jax():
    devices = jax.devices()
    assert len(devices) == 8
    for args in ((2, 4, 1), (1, -1, 1), (1, -1, 2), (-1, 2, 2), (2, 2, 2),
                 (1, -1, -1), (3, -1, 1), (1, 4, 1)):
        try:
            want = tuple(jmesh.create_mesh(*args, devices=devices)
                         .devices.shape)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e).replace(
                    "[", r"\[").replace("]", r"\]")):
                tmesh.mesh_shape(*args, len(devices))
            continue
        assert tmesh.mesh_shape(*args, len(devices)) == want, args


@pytest.mark.parametrize("axes", [("batch", None, "embed"),
                                  ("vocab", "embed"), ("embed", "heads"),
                                  ("layers", "mlp", "embed"),
                                  ("images", "seq"), ("cfg_batch", "height"),
                                  ("queries", "kv", "conv_io")])
def test_mesh_sharding_specs_match_jax(axes):
    mesh8 = jmesh.create_mesh(data=2, fsdp=2, tensor=2)
    want = tuple(jmesh.mesh_sharding(mesh8, *axes).spec)
    want = want + (None,) * (len(axes) - len(want))
    assert tmesh.mesh_sharding(None, *axes).spec == want


def _jax_specs(tree):
    out = {}
    for path, spec in jax.tree_util.tree_leaves_with_path(
            nn.get_partition_spec(tree),
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)):
        out[".".join(str(p.key) for p in path)] = tuple(spec)
    names = from_jax_params({k: 0 for k in out})
    return {n: out[k] for n, k in zip(names, out)}


def _abstract(module, *args, **kw):
    return jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args,
                                              **kw))["params"]


def _llm_cfgs(**kw):
    base = dict(hidden_size=128, intermediate_size=256, num_layers=2,
                num_heads=4, num_kv_heads=4)
    return jllama.llama_debug(**base, **kw), tllama.llama_debug(**base, **kw)


@pytest.mark.parametrize("kind", ["llm-none", "llm-int4-ia3",
                                  "llm-int8_full-lora", "llm-int8-ia3-lora",
                                  "agent", "vit", "vit-int8", "resampler",
                                  "seq_cls"])
def test_leaf_axes_match_jax_partition_specs(kind):
    """The port's table of logical axes, leaf by leaf, against the JAX
    modules' ``nn.with_logical_partitioning`` annotations; and the mesh
    axes both resolve them to."""
    ids = jnp.zeros((1, 8), jnp.int32)
    pos = jnp.arange(8)[None]
    llm_kw = {"llm-none": {},
              "llm-int4-ia3": {"quantization": "int4", "ia3": True},
              "llm-int8_full-lora": {"quantization": "int8_full",
                                     "lora_rank": 4},
              "llm-int8-ia3-lora": {"quantization": "int8", "ia3": True,
                                    "lora_rank": 2}}
    if kind in llm_kw:
        cfg_j, cfg_t = _llm_cfgs(**llm_kw[kind])
        want = _jax_specs(_abstract(jllama.LlamaForCausalLM(cfg_j), ids, pos,
                                    method="init_all"))
        module = tllama.LlamaForCausalLM(cfg_t, "meta")
    elif kind == "seq_cls":
        cfg_j, cfg_t = _llm_cfgs()
        want = _jax_specs(_abstract(jllama.LlamaForSequenceClassification(
            cfg_j, num_labels=3), ids))
        module = tllama.LlamaForSequenceClassification(cfg_t, 3, "meta")
    elif kind == "agent":
        cfg_j, cfg_t = _llm_cfgs(quantization="int4")
        acfg_j = jagent.AgentConfig(llm=cfg_j, vit_dim=64, resampler_heads=4)
        b, s, n = 1, 80, 1
        attn = jnp.ones((b, s), bool)
        idsm = jnp.zeros((b, s), bool).at[0, 1:65].set(True)
        want = _jax_specs(_abstract(
            jagent.ContinuousLVLM(acfg_j), jnp.zeros((b, s), jnp.int32),
            attn, jnp.zeros((b, s), jnp.int32), jnp.zeros((n, 256, 64)),
            jnp.zeros((n,), bool), jnp.zeros((n,), bool), idsm, idsm,
            jnp.full((n, 2), 0.5), method="init_all"))
        module = tagent.ContinuousLVLM(tagent.AgentConfig(
            llm=cfg_t, vit_dim=64, resampler_heads=4), "meta")
    elif kind.startswith("vit"):
        q = "int8" if kind == "vit-int8" else "none"
        want = _jax_specs(_abstract(
            jvit.VisionTransformer(jvit.vit_tiny_debug(
                image_size=56, output_dim=64, patch_pos=True,
                quantization=q)),
            jnp.zeros((1, 56, 56, 3)), jnp.zeros((1, 2))))
        module = tvit.VisionTransformer(tvit.vit_tiny_debug(
            image_size=56, output_dim=64, patch_pos=True, quantization=q),
            "meta")
    else:
        want = _jax_specs(_abstract(jres.Resampler(
            grid_size=4, embed_dim=64, num_heads=4, kv_dim=32),
            jnp.zeros((1, 9, 32))))
        module = tres.Resampler(4, 64, 4, kv_dim=32, device="meta")
    got = tmesh.logical_axes(module)
    assert got == want
    for rules in (tmesh.DEFAULT_RULES, (("embed", "tensor"),)
                  + tmesh.DEFAULT_RULES):
        for name, axes in got.items():
            assert tmesh.logical_to_mesh_axes(axes, rules) == tuple(
                nn.logical_to_mesh_axes(axes, rules)), (name, rules)


def test_maybe_initialize_is_a_noop_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert not torch.distributed.is_initialized()
    assert tdist.maybe_initialize("cpu") is False
    assert not torch.distributed.is_initialized()


def test_per_rank_bytes_are_the_split_fraction(mesh_run):
    """Each leaf split over fsdp and / or tensor keeps 1 / (their sizes)
    of its elements on every rank; the others stay whole."""
    _, _, outs = mesh_run
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    rt = SeedXRuntime.debug(dtype=torch.float32, device="cpu")
    sizes = {"data": 1, "fsdp": 2, "tensor": 2}
    split = 0
    for prefix, module in (("vit.", rt.vit), ("agent.", rt.agent)):
        for name, axes in tmesh.logical_axes(module).items():
            n = 1
            for s in tmesh.logical_to_mesh_axes(axes):
                for a in (s if isinstance(s, tuple) else (s,)):
                    n *= sizes.get(a, 1) if a else 1
            split += n > 1
            full = module.state_dict()[name].numel()
            for out in outs:
                assert json.loads(str(out["local_numel"]))[prefix + name] \
                    == full // n, name
    assert split > 20
    assert not outs[0]["graphs"]        # gloo: no captured programs


def test_sharded_agent_forward_matches_jax(mesh_run):
    _, want, outs = mesh_run
    for out in outs:
        _close(out["logits"], want["logits"], 2e-5)
        assert abs(float(out["total_loss"]) - want["total_loss"]) <= \
            1e-5 * abs(want["total_loss"])
        np.testing.assert_array_equal(out["logits"], outs[0]["logits"])


def test_sharded_comprehend_matches_jax(mesh_run):
    _, want, outs = mesh_run
    for out in outs:
        assert list(out["comprehend"]) == want["comprehend"]


def test_sharded_continuous_engine_matches_jax(mesh_run):
    _, want, outs = mesh_run
    for out in outs:
        got = json.loads(str(out["engine"]))
        for i, ((tokens, has_img), ref) in enumerate(zip(got, want["engine"])):
            assert tokens == list(ref["tokens"])
            assert has_img == bool(ref["has_img_output"])
            if ref["img_gen_feat"] is not None:
                _close(out[f"feat{i}"], ref["img_gen_feat"], 2e-5)


def test_sharded_denoise_matches_jax(mesh_run):
    """The replicated adapter on the sharded runtime (the ViT split) gives
    JAX's images (tests/test_sharding.py's tolerance)."""
    _, want, outs = mesh_run
    for out in outs:
        assert out["denoise"].shape == want["denoise"].shape
        np.testing.assert_allclose(out["denoise"], want["denoise"],
                                   atol=2e-2)
        np.testing.assert_array_equal(out["denoise"], outs[0]["denoise"])


def test_put_global_per_rank_slices(mesh_run):
    """``put_global``: each rank's slice of the batch, assembled over
    (data, fsdp) in rank order, replicated over tensor."""
    _, _, outs = mesh_run
    for r, out in enumerate(outs):
        # ranks 2f and 2f + 1 sit at fsdp coordinate f (mesh (1, 2, 2))
        np.testing.assert_array_equal(out["local"], np.full((2, 3), r // 2))
        np.testing.assert_array_equal(out["global"], np.concatenate(
            [np.full((2, 3), 0.0), np.full((2, 3), 1.0)]))


def test_pool_vit_matches_jax(mesh_run):
    rt_j = mesh_run[0]
    from seedx_tpu_torch.inference.runtime import SeedXRuntime

    rt_t = SeedXRuntime.debug(dtype=torch.float32, device="cpu")
    x = np.random.default_rng(13).standard_normal((2, 256, 64)).astype(
        np.float32)
    for down in (True, False):
        rt_j.vit_down = rt_t.vit_down = down
        np.testing.assert_allclose(
            rt_t.pool_vit(torch.from_numpy(x)).numpy(),
            np.asarray(rt_j.pool_vit(jnp.asarray(x))), rtol=0, atol=1e-6)


def _llm_params(cfg_j, seed, quant=None):
    model = jllama.LlamaForCausalLM(cfg_j)
    params = randomize(model.init(jax.random.PRNGKey(0),
                                  jnp.zeros((1, 4), jnp.int32),
                                  jnp.zeros((1, 4), jnp.int32),
                                  method="init_all")["params"], seed)
    return quantize_llama_params(params, mode=quant) if quant else params


def test_vocab_padding_at_tensor_4(tmp_path):
    """tensor 4 with ``vocab_pad_to`` 32336 (zero pad rows, pad logits
    -1e9) against the unpadded model; without padding the placement
    raises, as the JAX package's does."""
    cfg_j, _ = _llm_cfgs(dtype=jnp.float32)
    params = _llm_params(cfg_j, 21)
    ids = np.random.default_rng(22).integers(3, 32330, (2, 9))
    pad = 32336 - 32330
    padded = jax.tree_util.tree_map_with_path(
        lambda p, v: np.pad(v, ((0, pad), (0, 0))) if p[-1].key == "embedding"
        else np.pad(v, ((0, 0), (0, pad))) if (p[-2].key == "lm_head")
        else v, params)
    run = _start("vocab", 4, tmp_path, {"ids": ids, **_flat("llm", padded)})
    model = jllama.LlamaForCausalLM(cfg_j)
    emb = model.apply({"params": params}, jnp.asarray(ids), method="embed")
    pos = jnp.broadcast_to(jnp.arange(9), ids.shape)
    want = np.asarray(model.apply({"params": params}, emb, pos)[0])
    mesh4 = jmesh.create_mesh(1, 1, 4, devices=jax.devices()[:4])
    boxed = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32),
        jnp.zeros((1, 4), jnp.int32), method="init_all"))["params"]
    with pytest.raises(ValueError, match="divisible by 4"):
        jmesh.place_params(params, boxed, mesh4)
    outs = _join(run)
    for out in outs:
        assert "divisible by 4" in str(out["error"])
        assert int(out["table_rows"]) == 32336 // 4
        logits = out["logits"]
        assert logits.shape == (2, 9, 32336)
        assert (logits[..., 32330:] == -1e9).all()
        _close(logits[..., :32330], want, 2e-5)


def test_row_parallel_int4_takes_the_whole_row_scale(tmp_path, monkeypatch):
    """The int4 LLaMA (JAX's quantized weights) at tensor 2: down_proj
    row-parallel, each rank's rows quantized against the whole row's
    absmax (all-reduce MAX); the logits of the unsharded port within 1e-5
    of their scale; the mutant that quantizes against the shard's own
    absmax misses them by more.  (The unsharded int4 LLaMA against JAX's:
    tests/test_torch_models.py.)"""
    cfg_j, _ = _llm_cfgs(dtype=jnp.float32)
    params = _llm_params(cfg_j, 23, "int4")
    ids = np.random.default_rng(24).integers(3, 500, (2, 10))
    run = _start("rowpar", 2, tmp_path, {"ids": ids,
                                         **_flat("llm", params)})
    for out in _join(run):
        # debug widths: o_proj's 128 rows are one int4 group (attention
        # stays whole); down_proj's 256 split into one group a rank
        assert json.loads(str(out["roles"])) == {
            "q_proj": None, "o_proj": None, "gate_proj": "col",
            "down_proj": "row"}
        tol = 1e-5 * np.abs(out["full"]).max()
        assert np.abs(out["sharded"] - out["full"]).max() <= tol
        assert np.abs(out["mutant"] - out["full"]).max() > 10 * tol


def test_row_split_w4a8_plain_sums_to_the_unsharded_product(monkeypatch):
    """K2's plain version on two row shards with the whole row's absmax
    sums to the unsharded W4A8 product, the JAX package's (its Pallas
    kernel in interpret mode) within 1e-5 of its scale (fp32 reordering
    only); with each shard's own absmax (the mutant) it does not."""
    monkeypatch.setattr(seedx_tpu.ops.int4_matmul, "FORCE_KERNEL", True)
    g = torch.Generator().manual_seed(25)
    n_in, n_out = 512, 256
    w = torch.randn((n_in, n_out), generator=g) * n_in ** -0.5
    packed, scale = quantize_kernel_int4(w)
    x = torch.randn((6, n_in), generator=g)
    x[:, n_in // 2:] *= 0.05          # shard 1's rows far below the max
    full = tint4.int4_matmul_plain(x, packed, scale)
    amax = tint4.row_absmax(x)
    halves = [slice(0, n_in // 2), slice(n_in // 2, n_in)]
    g_rows = n_in // 2 // 128

    def shard(r, row_amax):
        return tint4.int4_matmul_plain(
            x[:, halves[r]], packed[r * n_in // 4:(r + 1) * n_in // 4],
            scale[r * g_rows:(r + 1) * g_rows], row_amax)

    want = np.asarray(seedx_tpu.ops.int4_matmul.int4_matmul_auto(
        jnp.asarray(x.numpy()), jnp.asarray(packed.numpy()),
        jnp.asarray(scale.numpy())))
    _close(full.numpy(), want, 1e-5)
    tol = 1e-5 * full.abs().max().item()
    assert (shard(0, amax) + shard(1, amax) - full).abs().max() <= tol
    assert (shard(0, None) + shard(1, None) - full).abs().max() > 10 * tol
