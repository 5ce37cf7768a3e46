"""Multimodal generation: prefill + decode loop (reference:
seedx_tpu/models/generation.py; src/models/mllm/seed_x.py:130-223).

Prompts are left-padded into length buckets; one prefill writes a
preallocated KV cache and a Python loop decodes one token per step with
an early exit once every row has emitted EOS.  Each decode step's kv mask
is one contiguous window per row (left pad to the newest token), so the
step reads only that window through the ragged decode kernel
(``LlamaConfig.decode_attention``).  ``constrain_image_tokens``,
``_sample``, ``_trim_and_spans`` and ``build_result`` are shared with the
continuous engine (inference/continuous.py).  The constrained image-token
decoder forces ``<img_00000>..<img_(n-1)></img>`` once ``<img>`` is
emitted; when every live row sits at ``<img>``, that forced span runs as
one (n+1)-token forward into the cache (the "chunk"), whose hidden states
feed the output resampler.  The JAX package segments its jitted
while-loops only to keep ``lax.cond`` out of the loop body; a Python loop
needs no such structure.  ``generate_tokens_cached`` (multi-turn chat)
prefills only a prompt's new suffix into a persistent cache and runs the
same decode loop.  Speculative decoding, ``script_ids`` and beam search are
not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from seedx_tpu_torch.models.agent import ContinuousLVLM, positions_from_mask
from seedx_tpu_torch.models.llama import init_kv_cache
from seedx_tpu_torch.text.vocab import DEFAULT_VOCAB, MultimodalVocab


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 512
    num_img_gen_tokens: int = 64
    do_sample: bool = False
    temperature: float = 0.7
    top_p: float = 0.5
    eos_token_id: int = 2
    pad_token_id: int = 0
    prompt_buckets: tuple = (128, 256, 512, 1024)


def constrain_image_tokens(prev_token: torch.Tensor, logits: torch.Tensor,
                           vocab: MultimodalVocab, num_img_gen_tokens: int
                           ) -> torch.Tensor:
    """AutoImageTokenGenerationProcessor as tensor arithmetic (reference
    generation.py:80-116).  prev_token [B]; logits [B, V] fp32.

    Forced continuation: <img> -> img_0, img_k -> img_{k+1}, img_{n-1} ->
    </img>; the forced id gets max + 10 and every other id -1e9.  Unforced:
    the image continuation ids and </img> get score 0.0."""
    img0 = vocab.img_token_start
    n = num_img_gen_tokens
    forced = torch.where(
        prev_token == vocab.boi, img0,
        torch.where((prev_token >= img0) & (prev_token < img0 + n - 1),
                    prev_token + 1,
                    torch.where(prev_token == img0 + n - 1, vocab.eoi, -1)))
    is_forced = forced >= 0
    v = logits.shape[-1]
    ids = torch.arange(v, device=logits.device)
    zero_ids = ((ids >= img0) & (ids < img0 + n)) | (ids == vocab.eoi)
    unforced = torch.where(zero_ids[None, :], 0.0, logits)
    win = logits.amax(dim=-1, keepdim=True) + 10.0
    onehot = ids[None, :] == torch.clamp(forced, min=0)[:, None]
    forced_logits = torch.where(onehot, win, torch.full_like(logits, -1e9))
    return torch.where(is_forced[:, None], forced_logits, unforced)


def _sample(logits: torch.Tensor, cfg: GenerationConfig,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Greedy argmax, or temperature + top-p sampling from ``generator``."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    logits = logits / cfg.temperature
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < cfg.top_p).sum(dim=-1, keepdim=True)
    cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
    filtered = torch.where(logits < cutoff, float("-inf"), logits)
    return torch.multinomial(torch.softmax(filtered, dim=-1), 1,
                             generator=generator)[:, 0]


@torch.no_grad()
def generate_tokens(model: ContinuousLVLM, prompt_embeds: torch.Tensor,
                    prompt_mask: torch.Tensor,
                    last_prompt_token: torch.Tensor,
                    gen_cfg: GenerationConfig,
                    vocab: MultimodalVocab = DEFAULT_VOCAB,
                    generator: Optional[torch.Generator] = None,
                    timings: Optional[Dict[str, float]] = None
                    ) -> Dict[str, torch.Tensor]:
    """prompt_embeds [B, P, D] (image embeds spliced), prompt_mask [B, P]
    bool LEFT-padded, last_prompt_token [B] -> {tokens [B, T], hidden
    [B, T, D], finished [B, T]}; hidden[:, i] is the state that produced
    tokens[:, i] (reference alignment, seed_x.py:196-207).

    ``timings``, when given, receives host seconds for "prefill" and
    "decode" (each closed by a device synchronize), the decode forwards
    in "decode_forwards" and the tokens they emitted in "decode_tokens"."""
    b, p, _ = prompt_embeds.shape
    dev = prompt_embeds.device
    t = gen_cfg.max_new_tokens
    cache = init_kv_cache(model.cfg.llm, b, p + t, device=dev)

    clock = PhaseClock(dev, timings)
    positions = positions_from_mask(prompt_mask)
    kv_valid = torch.cat([prompt_mask,
                          torch.zeros((b, t), dtype=torch.bool, device=dev)],
                         dim=-1)
    logits, hidden, _ = model.llm_step(prompt_embeds, positions, kv_valid,
                                       cache, 0)
    clock.mark("prefill")

    def valid_upto(n_valid: int) -> torch.Tensor:
        valid = kv_valid.clone()
        valid[:, p:p + n_valid] = True
        return valid

    out, steps, n = _decode_loop(
        model, cache, valid_upto, p, logits[:, -1].float(), hidden[:, -1],
        positions[:, -1], last_prompt_token.to(dev, torch.int64), gen_cfg,
        vocab, generator)
    clock.mark("decode")
    if timings is not None:
        timings["decode_forwards"] = steps
        timings["decode_tokens"] = n
    return out


def _decode_loop(model: ContinuousLVLM, cache, valid_upto, base: int,
                 prev_logits, prev_hidden, prev_pos, prev_token,
                 gen_cfg: GenerationConfig, vocab: MultimodalVocab,
                 generator: Optional[torch.Generator]):
    """The decode loop shared by ``generate_tokens`` and
    ``generate_tokens_cached``: one token per forward with an EOS exit,
    the constrained image span, and the forced (n+1)-token chunk once every
    live row sits at ``<img>``.  Output token n is written to cache
    position ``base + n``; ``valid_upto(m)`` is the kv mask with the first
    m generated positions valid.  Returns (out dict, forwards, tokens)."""
    b = prev_logits.shape[0]
    dev = prev_logits.device
    t = gen_cfg.max_new_tokens
    n_img = gen_cfg.num_img_gen_tokens
    out_tokens = torch.full((b, t), gen_cfg.pad_token_id, dtype=torch.int64,
                            device=dev)
    out_hidden = torch.zeros((b, t, prev_hidden.shape[-1]),
                             dtype=prev_hidden.dtype, device=dev)
    out_finished = torch.zeros((b, t), dtype=torch.bool, device=dev)
    finished = torch.zeros((b,), dtype=torch.bool, device=dev)
    forced_ids = torch.cat([
        torch.arange(vocab.img_token_start, vocab.img_token_start + n_img,
                     device=dev),
        torch.tensor([vocab.eoi], device=dev)])
    steps = 0
    n = 0
    while n < t:
        host = torch.stack([prev_token, finished.to(torch.int64)]).cpu()
        tok_host, fin_host = host[0].numpy(), host[1].numpy().astype(bool)
        if fin_host.all():
            break
        if (n + n_img + 1 <= t
                and np.all((tok_host == vocab.boi) & ~fin_host)):
            c = n_img + 1
            ids = forced_ids[None, :].expand(b, c)
            pos = prev_pos[:, None] + 1 + torch.arange(c, device=dev)[None, :]
            logits, hidden, _ = model.llm_step(model.embed_ids(ids), pos,
                                               valid_upto(n + c), cache,
                                               base + n)
            out_tokens[:, n:n + c] = ids
            out_hidden[:, n] = prev_hidden
            out_hidden[:, n + 1:n + c] = hidden[:, :n_img]
            out_finished[:, n:n + c] = finished[:, None]
            prev_logits = logits[:, -1].float()
            prev_hidden = hidden[:, -1]
            prev_pos = prev_pos + c
            prev_token = torch.full((b,), vocab.eoi, dtype=torch.int64,
                                    device=dev)
            n += c
            steps += 1
            continue
        constrained = constrain_image_tokens(prev_token, prev_logits, vocab,
                                             n_img)
        token = _sample(constrained, gen_cfg, generator)
        token = torch.where(finished, gen_cfg.pad_token_id, token)
        finished = finished | (token == gen_cfg.eos_token_id)
        out_tokens[:, n] = token
        out_hidden[:, n] = prev_hidden
        out_finished[:, n] = finished
        pos = prev_pos + 1
        logits, hidden, _ = model.llm_step(model.embed_ids(token[:, None]),
                                           pos[:, None], valid_upto(n + 1),
                                           cache, base + n)
        prev_logits = logits[:, 0].float()
        prev_hidden = hidden[:, 0]
        prev_pos = pos
        prev_token = token
        n += 1
        steps += 1
    return ({"tokens": out_tokens, "hidden": out_hidden,
             "finished": out_finished}, steps, n)


@torch.no_grad()
def generate_tokens_cached(model: ContinuousLVLM, cache, seg_embeds,
                           seg_start: int, seg_len: int,
                           last_prompt_token: int, gen_cfg: GenerationConfig,
                           vocab: MultimodalVocab = DEFAULT_VOCAB,
                           generator: Optional[torch.Generator] = None,
                           timings: Optional[Dict[str, float]] = None):
    """Prefix-cached single-prompt generation for multi-turn chat
    (reference ``generate_tokens_cached``, generation.py:537-739).

    ``cache`` [L, 1, C, ...] already holds valid KV at positions
    [0, seg_start); ``seg_embeds`` [1, Sb, D] is the prompt's new suffix,
    right-padded, of which ``seg_len`` tokens are real.  Only the suffix
    is prefilled, at ``seg_start``; attending to the cached prefix gives
    what a full prefill would.  Stale KV past ``seg_start + seg_len`` (the
    last turn's reply, re-serialized) is overwritten or masked.  Decode
    then runs ``generate_tokens``' loop, writing at absolute positions so
    the next turn can extend the prefix.  Returns (out dict, cache,
    seg_start + seg_len + tokens decoded); the cache is updated in
    place.  ``timings`` as in ``generate_tokens``."""
    dev = seg_embeds.device
    c = cache[0].shape[2]
    sb = seg_embeds.shape[1]
    clock = PhaseClock(dev, timings)
    positions = (seg_start + torch.arange(sb, device=dev))[None]
    kv_valid = (torch.arange(c, device=dev) < seg_start + seg_len)[None]
    logits, hidden, _ = model.llm_step(seg_embeds, positions, kv_valid,
                                       cache, seg_start)
    clock.mark("prefill")
    p_total = seg_start + seg_len
    span = torch.arange(c, device=dev)
    out, steps, n = _decode_loop(
        model, cache, lambda n_valid: (span < p_total + n_valid)[None],
        p_total, logits[:, seg_len - 1].float(), hidden[:, seg_len - 1],
        torch.full((1,), p_total - 1, dtype=torch.int64, device=dev),
        torch.full((1,), last_prompt_token, dtype=torch.int64, device=dev),
        gen_cfg, vocab, generator)
    clock.mark("decode")
    if timings is not None:
        timings["decode_forwards"] = steps
        timings["decode_tokens"] = n
    return out, cache, p_total + n


class PhaseClock:
    """Host seconds between marks, each closed by a device synchronize,
    written into ``timings``; a no-op when ``timings`` is None."""

    def __init__(self, device: torch.device,
                 timings: Optional[Dict[str, float]]):
        self.device, self.timings = device, timings
        self.t0 = self._now() if timings is not None else 0.0

    def _now(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def mark(self, name: str) -> None:
        if self.timings is None:
            return
        now = self._now()
        self.timings[name] = now - self.t0
        self.t0 = now


def _trim_and_spans(tokens: np.ndarray, gen_cfg: GenerationConfig,
                    vocab: MultimodalVocab):
    """EOS trim + </img> span indices (reference generation.py:876-885)."""
    eos_positions = np.where(tokens == gen_cfg.eos_token_id)[0]
    end = int(eos_positions[0]) + 1 if eos_positions.size else len(tokens)
    tokens = tokens[:end]
    n_img = gen_cfg.num_img_gen_tokens
    eoi_indices = [int(i) for i in np.where(tokens == vocab.eoi)[0]
                   if i >= n_img]
    return tokens, eoi_indices


def build_result(tokens: np.ndarray, eoi_indices, img_gen_feat, tokenizer,
                 vocab: MultimodalVocab, num_img_gen_tokens: int
                 ) -> Dict[str, Any]:
    """Result dict from trimmed tokens + spans: forced image ids and <img>
    markers are dropped from the text (reference: seed_x.py:201-215)."""
    text_mask = np.ones(len(tokens), bool)
    for j in eoi_indices:
        text_mask[j - num_img_gen_tokens:j] = False
    text_mask[tokens == vocab.boi] = False
    return {"text": tokenizer.decode(tokens[text_mask]),
            "has_img_output": bool(eoi_indices),
            "img_gen_feat": img_gen_feat,
            "num_gen_imgs": len(eoi_indices),
            "tokens": tokens}


@torch.no_grad()
def generate_batch(model: ContinuousLVLM, tokenizer, requests,
                   gen_cfg: Optional[GenerationConfig] = None,
                   generator: Optional[torch.Generator] = None,
                   timings: Optional[Dict[str, float]] = None):
    """Batched generation: one prefill + decode loop for many prompts.
    Every request is a dict {"input_ids": list[int], "image_embeds":
    [N_i, T, vit_dim] or None, "embeds_cmp_mask": [N_i] bool or None,
    "ids_cmp_mask": [S_i] bool or None, "patch_positions": [N_i, 2] or
    None}.  Returns one result dict per request."""
    vocab = tokenizer.vocab
    gen_cfg = gen_cfg or GenerationConfig(eos_token_id=tokenizer.eos_token_id,
                                          pad_token_id=tokenizer.pad_token_id)
    dev = next(model.buffers()).device
    b = len(requests)
    lens = [len(r["input_ids"]) for r in requests]
    s_max = max(lens)
    bucket = next((x for x in gen_cfg.prompt_buckets if x >= s_max), s_max)

    ids_padded = np.full((b, bucket), gen_cfg.pad_token_id, np.int64)
    mask = np.zeros((b, bucket), bool)
    cmp_padded = np.zeros((b, bucket), bool)
    any_cmp = False
    for i, r in enumerate(requests):
        s = lens[i]
        ids_padded[i, bucket - s:] = np.asarray(r["input_ids"], np.int64)
        mask[i, bucket - s:] = True
        cm = r.get("ids_cmp_mask")
        if cm is not None:
            cmp_padded[i, bucket - s:] = np.asarray(cm, bool)
            any_cmp = True

    with_img = [r for r in requests if r.get("image_embeds") is not None]
    image_embeds = embeds_cmp = patch_pos = None
    if with_img:
        image_embeds = torch.cat([torch.as_tensor(r["image_embeds"],
                                                  device=dev)
                                  for r in with_img])
        embeds_cmp = torch.as_tensor(np.concatenate(
            [np.asarray(r["embeds_cmp_mask"], bool) for r in with_img]),
            device=dev)
        if any(r.get("patch_positions") is not None for r in with_img):
            # missing positions default to the thumbnail's center
            patch_pos = torch.cat([
                torch.as_tensor(r["patch_positions"], dtype=torch.float32,
                                device=dev)
                if r.get("patch_positions") is not None
                else torch.full((r["image_embeds"].shape[0], 2), 0.5,
                                device=dev)
                for r in with_img])

    prompt_embeds = model.embed_with_images(
        torch.as_tensor(ids_padded, device=dev), image_embeds,
        torch.as_tensor(cmp_padded, device=dev) if any_cmp else None,
        embeds_cmp, patch_pos)
    last_tokens = torch.as_tensor([r["input_ids"][-1] for r in requests],
                                  device=dev)
    out = generate_tokens(model, prompt_embeds,
                          torch.as_tensor(mask, device=dev), last_tokens,
                          gen_cfg, vocab, generator=generator,
                          timings=timings)
    all_tokens = out["tokens"].cpu().numpy()

    n_img = gen_cfg.num_img_gen_tokens
    rows, span_list = [], []
    for i in range(b):
        tokens, eoi_indices = _trim_and_spans(all_tokens[i], gen_cfg, vocab)
        rows.append((tokens, eoi_indices))
        span_list.extend((i, j) for j in eoi_indices)
    img_gen_all = None
    if span_list:
        spans = torch.stack([out["hidden"][i, j - n_img:j]
                             for i, j in span_list])
        img_gen_all = model.decode_image_feats(spans)

    results, consumed = [], 0
    for tokens, eoi_indices in rows:
        img_gen_feat = None
        if eoi_indices:
            img_gen_feat = img_gen_all[consumed:consumed + len(eoi_indices)]
            consumed += len(eoi_indices)
        results.append(build_result(tokens, eoi_indices, img_gen_feat,
                                    tokenizer, vocab, n_img))
    return results


def generate(model: ContinuousLVLM, tokenizer, input_ids,
             image_embeds=None, embeds_cmp_mask=None, ids_cmp_mask=None,
             patch_positions=None, gen_cfg: Optional[GenerationConfig] = None,
             generator: Optional[torch.Generator] = None,
             timings: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Single-prompt generation (reference ``ContinuousLVLM.generate``,
    seed_x.py:130-223): {text, has_img_output, img_gen_feat, num_gen_imgs,
    tokens}."""
    ids = np.asarray(input_ids)
    if ids.ndim == 2:
        if ids.shape[0] != 1:
            raise ValueError("generate() is single-prompt; use "
                             "generate_batch for multiple prompts")
        ids = ids[0]
    cm = np.asarray(ids_cmp_mask) if ids_cmp_mask is not None else None
    if cm is not None and cm.ndim == 2:
        cm = cm[0]
    request = {"input_ids": list(ids), "image_embeds": image_embeds,
               "embeds_cmp_mask": embeds_cmp_mask, "ids_cmp_mask": cm,
               "patch_positions": patch_positions}
    return generate_batch(model, tokenizer, [request], gen_cfg=gen_cfg,
                          generator=generator, timings=timings)[0]
