"""DeepSeek-V2 in the port (latent attention over a latent KV cache, sparse
experts, YaRN) against the plain fp32 reference ``plain_deepseek_v2.py``,
at a tiny size: hidden 64, 4 heads, kv_lora_rank 32, rope 16, nope 32, v
32, 8 experts top-2 with 1 shared expert, layer 0 dense, 3 layers, YaRN
factor 40.  The model runs in fp32 here, so what separates it from the
reference is the order of fp32 sums (the absorbed decode multiplies
through W_UK / W_UV instead of expanding k and v): each tolerance below
says so.  The router is drawn wide (std 0.5) so that no top-k choice sits
on a near-tie that such rounding could flip.
"""

import types

import numpy as np
import pytest
import torch

import plain_deepseek_v2 as plain
from seedx_tpu_torch.inference.continuous import ContinuousEngine
from seedx_tpu_torch.models.agent import AgentConfig, ContinuousLVLM
from seedx_tpu_torch.models.generation import (BeamState, DecodeState,
                                               GenerationConfig)
from seedx_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                          init_kv_cache, init_paged_kv_pool)
from seedx_tpu_torch.ops import attention as tattn
from seedx_tpu_torch.ops import moe as tmoe
from seedx_tpu_torch.ops import rope as trope
from seedx_tpu_torch.text import prompts
from seedx_tpu_torch.text.tokenizer import load_tokenizer

torch.set_num_threads(2)

ROPE = dict(factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=0.707, mscale_all_dim=0.707, type="yarn")
HF = dict(hidden_size=64, num_attention_heads=4, qk_nope_head_dim=32,
          qk_rope_head_dim=16, v_head_dim=32, kv_lora_rank=32,
          num_hidden_layers=3, first_k_dense_replace=1, n_routed_experts=8,
          num_experts_per_tok=2, n_shared_experts=1, routed_scaling_factor=1.0,
          intermediate_size=128, moe_intermediate_size=48, rms_norm_eps=1e-6,
          rope_theta=10000, rope_scaling=ROPE, vocab_size=32330)
# fp32 sums in another order (and the absorbed decode's other products):
# logits of magnitude ~3 agree to this
TOL = 2e-5


def llm_config(hf=HF, **kw) -> LlamaConfig:
    rs = hf["rope_scaling"]
    args = dict(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf["num_attention_heads"],
        rope_theta=float(hf["rope_theta"]), rms_eps=hf["rms_norm_eps"],
        max_position_embeddings=4096,
        kv_lora_rank=hf["kv_lora_rank"],
        qk_nope_head_dim=hf["qk_nope_head_dim"],
        qk_rope_head_dim=hf["qk_rope_head_dim"],
        v_head_dim=hf["v_head_dim"],
        n_routed_experts=hf["n_routed_experts"],
        num_experts_per_tok=hf["num_experts_per_tok"],
        moe_intermediate_size=hf["moe_intermediate_size"],
        n_shared_experts=hf["n_shared_experts"],
        first_k_dense_replace=hf["first_k_dense_replace"],
        routed_scaling_factor=hf["routed_scaling_factor"],
        yarn_factor=float(rs["factor"]),
        yarn_original_max_position=rs["original_max_position_embeddings"],
        yarn_beta_fast=rs["beta_fast"], yarn_beta_slow=rs["beta_slow"],
        yarn_mscale=rs["mscale"], yarn_mscale_all_dim=rs["mscale_all_dim"],
        dtype=torch.float32)
    return LlamaConfig(**{**args, **kw})


def fill(module, seed=0):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.state_dict().items():
            if not t.is_floating_point():
                continue
            n = torch.randn(t.shape, generator=g)
            std = 0.5 if "router" in name else 0.08
            t.copy_(1 + 0.1 * n if name.endswith("scale") else n * std)
    return module


@pytest.fixture(scope="module")
def model():
    return fill(LlamaForCausalLM(llm_config())).eval()


@pytest.fixture(scope="module")
def runtime():
    cfg = AgentConfig(llm=llm_config(), num_img_in_tokens=4,
                      num_img_out_tokens=4, vit_dim=32, resampler_heads=4,
                      vit_down=False, dtype=torch.float32)
    agent = fill(ContinuousLVLM(cfg), seed=1).eval()
    return types.SimpleNamespace(agent=agent, agent_cfg=cfg,
                                 tokenizer=load_tokenizer())


@pytest.mark.parametrize("length", [1, 9, 33])
def test_forward_matches_plain_reference(model, length):
    x = torch.randn(1, length, 64, generator=torch.Generator().manual_seed(
        length))
    with torch.no_grad():
        got, _, _ = model(x, torch.arange(length)[None])
    want = plain.forward(HF, model.state_dict(), x[0])
    assert want.abs().max() > 1.0
    torch.testing.assert_close(got[0], want, rtol=0, atol=TOL)


@pytest.mark.parametrize("per_row", [False, True])
def test_prefill_then_decode_through_the_latent_cache(model, per_row):
    """A 2-row prefill (right-padded), then one-token steps through the
    latent cache (absorbed form), each row's logits against the
    reference's full forward over its own sequence."""
    g = torch.Generator().manual_seed(5)
    # ragged rows need per-row offsets; the scalar-offset step, equal ones
    lens, total = ([6, 11] if per_row else [11, 11]), 16
    x = torch.randn(2, total, 64, generator=g)
    cfg = model.cfg
    cache = init_kv_cache(cfg, 2, total)
    assert cache[0].shape == (3, 2, total, 32 + 16)
    span = torch.arange(total)
    got = [[], []]
    with torch.no_grad():
        p = max(lens)
        kvv = span[None, :p] < torch.tensor(lens)[:, None]
        lg, _, _ = model(x[:, :p], span[None, :p].repeat(2, 1), kvv, cache, 0)
        for b in range(2):
            got[b].append(lg[b, :lens[b]])
        pos = torch.tensor(lens)
        for _ in range(total - max(lens)):
            kvv = span[None, :] <= pos[:, None]
            xt = x[torch.arange(2), pos][:, None]
            lg, _, _ = model(xt, pos[:, None], kvv, cache,
                             pos if per_row else int(pos[0]))
            for b in range(2):
                got[b].append(lg[b])
            pos = pos + 1
    for b in range(2):
        n = lens[b] + total - max(lens)
        want = plain.forward(HF, model.state_dict(), x[b, :n])
        torch.testing.assert_close(torch.cat(got[b]), want, rtol=0, atol=TOL)


def _requests(tok, texts):
    return [{"input_ids": [tok.bos_token_id] + tok.encode(t)} for t in texts]


def _served_gaps(rt, requests, results, image=None):
    """Per request, the widest gap of a served token below the
    reference's best at every served position (its logits over the
    prompt and the tokens served before it)."""
    agent = rt.agent
    gaps = []
    for req, res in zip(requests, results):
        toks = [int(t) for t in res["tokens"]]
        ids = list(req["input_ids"]) + toks[:-1]
        kw = {}
        if image is not None:
            mask = np.zeros((1, len(ids)), bool)
            mask[0, :len(req["input_ids"])] = req["ids_cmp_mask"]
            kw = dict(image_embeds=image, ids_cmp_mask=torch.as_tensor(mask),
                      embeds_cmp_mask=torch.ones(1, dtype=torch.bool))
        with torch.no_grad():
            emb = agent.embed_with_images(torch.tensor([ids]), **kw)[0]
        lg = plain.forward(HF, agent.llm.state_dict(), emb)
        lg = lg[len(req["input_ids"]) - 1:]
        tok = torch.tensor(toks)
        gaps.append(float((lg.max(-1).values
                           - lg.gather(1, tok[:, None])[:, 0]).max()))
    return gaps


def test_engine_serves_ragged_prompts(runtime):
    """ContinuousEngine (bucket prefill, decode chunks through the latent
    cache, rolling admission over 2 slots) serves 4 ragged prompts
    greedily: every served token is the reference's best, to the fp32
    tolerance."""
    tok = runtime.tokenizer
    reqs = _requests(tok, ["hello world", "abc abc abc abc abc",
                           "the cat sat on the mat", "x"])
    eng = ContinuousEngine(runtime, slots=2, max_new_tokens=6, chunk_steps=3,
                           prompt_buckets=(16, 32))
    eng.warmup()
    ids = [eng.submit(r) for r in reqs]
    res = eng.run()
    out = [res[i] for i in ids]
    assert all(len(r["tokens"]) == 6 for r in out)
    assert int(runtime.agent.llm.layers.experts_active) > 0
    assert max(_served_gaps(runtime, reqs, out)) <= TOL


def test_image_splice_through_continuous_lvlm(runtime):
    """A request with resampled image embeddings spliced into its prompt
    (ContinuousLVLM.embed_with_images at admission), served through the
    engine, against the reference over the same spliced embeddings."""
    tok = runtime.tokenizer
    ids = ([tok.bos_token_id] + tok.encode("[INST] ")
           + tok.encode(prompts.multi_patch_image_string(1, 4))
           + tok.encode(" what is it? [/INST]\n"))
    image = torch.randn(1, 16, 32, generator=torch.Generator().manual_seed(9))
    req = {"input_ids": ids, "image_embeds": image,
           "embeds_cmp_mask": np.ones((1,), bool),
           "ids_cmp_mask": prompts.cmp_mask_from_ids(ids)}
    assert req["ids_cmp_mask"].sum() == 4
    eng = ContinuousEngine(runtime, slots=2, max_new_tokens=5, chunk_steps=2,
                           prompt_buckets=(48,))
    rid = eng.submit(req)
    res = eng.run()[rid]
    assert max(_served_gaps(runtime, [req], [res], image=image)) <= TOL


@pytest.mark.parametrize("gated", [False, True])
def test_moe_gemm_plain_matches_a_per_expert_loop(gated):
    """moe_gemm_plain over expert-sorted rows, experts 1, 4 and 6 given no
    rows, against each expert's rows through torch.matmul."""
    g = torch.Generator().manual_seed(3)
    counts = [3, 0, 5, 1, 0, 7, 0, 2]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(counts)]),
                           dtype=torch.int32)
    x = torch.randn(sum(counts), 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(8, 64, 32, generator=g) * 0.1).to(torch.bfloat16)
    w2 = (torch.randn(8, 64, 32, generator=g) * 0.1).to(torch.bfloat16)
    active = torch.zeros((), dtype=torch.int64)
    got = tmoe.moe_gemm(x, w, offsets, w2 if gated else None, active)
    assert int(active) == 5
    assert got.dtype == (torch.bfloat16 if gated else torch.float32)
    at = 0
    for e, n in enumerate(counts):
        xe = x[at:at + n].float()
        want = xe @ w[e].float()
        if gated:
            want = (torch.nn.functional.silu(want) * (xe @ w2[e].float())
                    ).to(torch.bfloat16)
        # the same fp32 products: equal bits
        assert torch.equal(got[at:at + n], want)
        at += n


def test_routing_sorts_rows_by_expert_in_static_shapes():
    ids = torch.tensor([[3, 0], [0, 2], [3, 2], [1, 0]])
    order, offsets = tmoe.sort_rows(ids, 5)
    assert offsets.tolist() == [0, 3, 4, 6, 8, 8]
    flat = ids.reshape(-1)
    assert flat[order].tolist() == [0, 0, 0, 1, 2, 2, 3, 3]
    # stable: within an expert, (token, slot) rows in order
    assert order[:3].tolist() == [1, 2, 7]
    w, e = tmoe.route(torch.randn(4, 8), torch.randn(8, 5), 2)
    assert w.shape == e.shape == (4, 2) and (w[:, 0] >= w[:, 1]).all()


@pytest.mark.parametrize("where", ["layer", "model"])
def test_pad_tokens_route_to_no_expert(model, monkeypatch, where):
    """The pad tokens of a right-padded batch go to the sentinel expert
    past the last, so the offsets K6 is handed end at the real tokens'
    rows: in ``moe_experts`` with ``keep`` (real tokens' sums as without
    it, the pads' 0), and in every MoE layer of a padded prefill."""
    ends = []
    real = tmoe.moe_gemm

    def seen(x, w, offsets, *rest):
        ends.append(int(offsets[-1]))
        return real(x, w, offsets, *rest)

    monkeypatch.setattr(tmoe, "moe_gemm", seen)
    g = torch.Generator().manual_seed(6)
    k = HF["num_experts_per_tok"]
    if where == "layer":
        keep = torch.tensor([True, True, False, True, False, False])
        x = torch.randn(6, 64, generator=g).to(torch.bfloat16)
        w = [(torch.randn(shape, generator=g) * 0.1).to(torch.bfloat16)
             for shape in ((8, 64, 32), (8, 64, 32), (8, 32, 64))]
        router = torch.randn(64, 8, generator=g)
        whole = tmoe.moe_experts(x, router, *w, k)
        got = tmoe.moe_experts(x, router, *w, k, keep=keep)
        assert ends == [6 * k] * 2 + [3 * k] * 2
        # fp32 matmuls over fewer rows may block their sums otherwise
        torch.testing.assert_close(got[keep], whole[keep], rtol=0,
                                   atol=1e-6)
        assert torch.equal(got[~keep], torch.zeros_like(got[~keep]))
        return
    lens = [5, 12]
    x = torch.randn(2, 12, 64, generator=g)
    kvv = torch.arange(12)[None] < torch.tensor(lens)[:, None]
    with torch.no_grad():
        model(x, torch.arange(12)[None].repeat(2, 1), kvv,
              init_kv_cache(model.cfg, 2, 12), 0)
    moe_layers = HF["num_hidden_layers"] - HF["first_k_dense_replace"]
    assert ends == [k * sum(lens)] * (2 * moe_layers)


@pytest.mark.parametrize("what", ["inv_freq", "scale", "deinterleave"])
def test_yarn_against_closed_forms(what):
    import math

    if what == "inv_freq":
        dim, theta = 64, 10000.0
        low = math.floor(64 * math.log(4096 / (32 * 2 * math.pi))
                         / (2 * math.log(theta)))
        high = math.ceil(64 * math.log(4096 / (1 * 2 * math.pi))
                         / (2 * math.log(theta)))
        assert (low, high) == trope.yarn_correction_range(dim, theta, 4096,
                                                          32, 1)
        i = torch.arange(32).float()
        f_extra = theta ** (-2 * i / 64)
        m = 1 - torch.clamp((i - low) / (high - low), 0, 1)
        want = f_extra / 40 * (1 - m) + f_extra * m
        got = trope.yarn_inv_freq(dim, theta, 40, 4096, 32, 1)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
        # the fast dims keep their frequency, the slow ones are divided
        assert float(got[0]) == pytest.approx(float(f_extra[0]))
        assert float(got[-1]) == pytest.approx(float(f_extra[-1]) / 40)
    elif what == "scale":
        cfg = llm_config(hidden_size=2048, num_heads=16, num_kv_heads=16,
                         qk_nope_head_dim=128, qk_rope_head_dim=64,
                         v_head_dim=128, kv_lora_rank=512)
        ms = 0.1 * 0.707 * math.log(40) + 1
        assert cfg.softmax_scale == pytest.approx(192 ** -0.5 * ms * ms)
        assert cfg.softmax_scale == pytest.approx(0.11472, abs=5e-6)
        # mscale == mscale_all_dim: cos and sin unscaled
        cos, _ = cfg.rope_tables(torch.zeros(1, dtype=torch.long))
        assert torch.equal(cos, torch.ones(1, 64))
    else:
        x = torch.arange(8.0)
        assert trope.deinterleave(x).tolist() == [0, 2, 4, 6, 1, 3, 5, 7]


@pytest.mark.parametrize("dims,flash", [((192, 128), False),
                                        ((128, 128), True),
                                        ((64, 64), True),
                                        ((104, 104), True),
                                        ((256, 256), False)])
def test_auto_dispatch_sends_what_k1_cannot_take_to_plain(dims, flash):
    """"auto" on a CUDA bf16 multi-row call: K1 where q / k and v share a
    head dim it takes (ViT-bigG's 104 zero-padded to 128), the plain path
    for MLA's (192, 128) and anything over 128."""
    def fake(d):
        return types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16,
                                     shape=(1, 16, 4, d))

    assert tattn._use_flash(fake(dims[0]), fake(dims[1]), 16, None,
                            None) is flash
    # on the CPU the (192, 128) shape runs (plain) instead of raising
    q = torch.randn(1, 5, 2, dims[0])
    out = tattn.dot_product_attention(q, q, torch.randn(1, 5, 2, dims[1]),
                                      causal=True)
    assert out.shape == (1, 5, 2, dims[1])


def _refusals():
    def engine(**kw):
        return lambda rt: ContinuousEngine(rt, slots=2, max_new_tokens=4,
                                           prompt_buckets=(16,), **kw)

    def spec(rt):
        gen = GenerationConfig(max_new_tokens=4, spec_k=2)
        cache = init_kv_cache(rt.agent_cfg.llm, 1, 8)
        DecodeState(rt.agent, cache, 1, gen, rt.tokenizer.vocab, None,
                    spec_k=2, hist_len=8)

    def beam(rt):
        gen = GenerationConfig(max_new_tokens=4, num_beams=2)
        cache = init_kv_cache(rt.agent_cfg.llm, 2, 8)
        BeamState(rt.agent, cache, 1, 4, gen, rt.tokenizer.vocab, None)

    def mesh(rt):
        from seedx_tpu_torch.parallel.mesh import place_params

        place_params(rt.agent, None)

    def train(rt):
        rt.agent.llm.forward_train(torch.zeros(1, 4, 64),
                                   torch.arange(4)[None])

    def fused_step(rt):
        cfg = rt.agent_cfg.llm
        rt.agent.llm(torch.zeros(2, 2, 64), torch.zeros(2, 2, dtype=torch.long),
                     torch.ones(2, 8, dtype=torch.bool),
                     init_kv_cache(cfg, 2, 8), torch.zeros(2, dtype=torch.long),
                     write_widths=torch.ones(2, dtype=torch.long))

    return {
        "int4": lambda rt: llm_config(quantization="int4"),
        "int8": lambda rt: llm_config(quantization="int8"),
        "int8_kv": lambda rt: llm_config(kv_quantization="int8"),
        "lora": lambda rt: llm_config(lora_rank=4),
        "paged": engine(paged=True, page_size=4),
        "fused_prefill": engine(fused_prefill=True),
        "paged_pool": lambda rt: init_paged_kv_pool(rt.agent_cfg.llm, 16),
        "fused_step": fused_step,
        "spec_decode": spec,
        "beam": beam,
        "mesh": mesh,
        "training": train,
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_unsupported_combinations_are_refused(runtime, case):
    with pytest.raises(ValueError, match="latent attention|sparse experts"):
        _refusals()[case](runtime)


def test_moe_only_and_mla_only_configs_run():
    """The two kinds are independent: sparse experts under the LLaMA
    attention, and latent attention with every layer dense."""
    for kw in (dict(kv_lora_rank=0), dict(n_routed_experts=0)):
        m = fill(LlamaForCausalLM(llm_config(**kw)))
        x = torch.randn(1, 5, 64, generator=torch.Generator().manual_seed(2))
        with torch.no_grad():
            lg, _, _ = m(x, torch.arange(5)[None])
        assert torch.isfinite(lg).all()


def test_plain_reference_matches_the_benchmarks():
    """tests/plain_deepseek_v2.py and benchmark/reference/deepseek_v2.py
    hold the same equations: on weights drawn by leaf name from one seed,
    their logits agree (fp32 sums in another order: the benchmark's
    reference computes a block of experts at a time)."""
    from benchmark.harness.weights import draw
    from benchmark.reference import deepseek_v2 as bref

    cfg = dict(HF, serving={"kv_cache": "bfloat16"},
               markers={"img0": 32000, "boi": 32324, "eoi": 32325,
                        "bop": 32326, "eop": 32327})
    ref = bref.DeepSeekV2(7, cfg, torch.device("cpu"))
    ids = torch.tensor([1, 500, 20, 7, 900, 33, 4, 18, 2000])
    got = ref.logits([{"ids": ids, "rows": torch.arange(len(ids))}])[0]
    params = {name: draw(7, "agent.llm." + name, shape, torch.bfloat16,
                         "cpu")
              for name, shape in bref.leaf_shapes(cfg).items()}
    emb = params["embed_tokens.embedding"][ids].float()
    want = plain.forward(HF, params, emb)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
