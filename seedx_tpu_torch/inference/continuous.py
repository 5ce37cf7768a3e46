"""Continuous (slot-based) batching: rolling admission into a live decode
(reference: seedx_tpu/inference/continuous.py).

``ServingEngine.flush`` batches, but every request of a batch starts and
finishes together, so one long answer holds the whole batch.  This engine
keeps a fixed pool of B *slots*:

  * each slot owns rows of one preallocated KV cache sized
    ``max(prompt_buckets) + max_new_tokens`` -- or, with ``paged=True``, a
    shared pool of fixed-size pages and a per-slot block table, so a
    request holds only ``ceil((p_len + budget) / page)`` pages;
  * prompts prefill, right-padded to a prompt bucket, into a fresh
    mini-cache that is copied into a free slot's rows (or pages);
  * decode advances every slot together in chunks of up to
    ``chunk_steps`` steps; each row has its own position, cache depth and
    kv window ``[0, pos]``, so the one-token step reads each row's window
    only (the ragged decode kernel; paged through the block tables);
  * finished rows freeze (their writes land in their own rows, or, once
    harvested, in the reserved dump page 0) and are harvested and refilled
    between chunks.

Fused (Sarathi-style chunked) prefill, ``fused_prefill=True`` (off by
default, as in the JAX package): admission only writes the request's
prompt embeddings into a per-slot buffer, and while any slot is
mid-prompt the chunk runs *mixed* steps in which decoding rows emit one
token and prefilling rows consume up to ``prefill_width`` prompt tokens,
their KV written at per-row offsets (``models/llama.py`` packed fused
step; the ragged kernel's multi-query "stair" mode on the card).  A
mixed step carries P = slots + prefill_width real tokens: the decoding
rows' tokens, then a ``prefill_width``-token prompt chunk shared
greedily in row order across the prefilling rows.  The host keeps an
exact replay of the prompt tokens each slot still has to prefill.

Each chunk is ``chunk_steps`` replays of one step program
(``decode_step`` or ``mixed_step``, in place on the engine's state
tensors; on the card a captured CUDA graph, ``utils/graphs.py``), then
one host read of the steps in which some row ran: a step after the last
running row stopped is a no-op, as the JAX chunk's while-loop would not
have run it.  Admission and harvest write into the same tensors, never
replace them.  ``warmup`` runs the admission grid and captures the step
programs ahead of serving.

Greedy by default; ``do_sample`` draws from a ``torch.Generator`` seeded
with ``seed`` (the JAX engine's ``jax.random`` stream gives other
numbers): a chunk's draws are made before it and the ones its no-op steps
did not take are given back (``generation.SampleNoise``), so the stream
advances one draw a step that ran, as the eager chunk loop's.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from seedx_tpu_torch.models.generation import (GenerationConfig,
                                               SampleNoise, _sample,
                                               _trim_and_spans, build_result,
                                               constrain_image_tokens)
from seedx_tpu_torch.models.llama import init_kv_cache, init_paged_kv_pool
from seedx_tpu_torch.utils import profiling
from seedx_tpu_torch.utils.graphs import Program


@torch.no_grad()
def _prefill(model, embeds, p_lens, bucket: int):
    """Right-padded prompts [b, bucket, D] -> (mini_cache [L, b, bucket,
    ...], last_logits [b, V] fp32, last_hidden [b, D]): one forward for
    every admitted request of a bucket, the LM head on each prompt's last
    row only."""
    b = embeds.shape[0]
    dev = embeds.device
    cache = init_kv_cache(model.cfg.llm, b, bucket, device=dev,
                          kv_heads=model.llm.kv_heads)
    positions = torch.arange(bucket, device=dev).repeat(b, 1)
    kv_valid = torch.arange(bucket, device=dev)[None, :] < p_lens[:, None]
    logits, hidden, _ = model.llm_step(embeds, positions, kv_valid, cache, 0,
                                       last=p_lens - 1)
    return cache, logits[:, 0].float(), hidden[:, 0]


def _arm(state, row: int, p_len: int, last_logits, last_hidden,
         last_token: int, budget: int) -> None:
    """Point slot ``row`` at a freshly prefilled request."""
    state["pos"][row] = p_len
    state["n"][row] = 0
    state["prev_logits"][row] = last_logits
    state["prev_hidden"][row] = last_hidden
    state["prev_token"][row] = last_token
    state["running"][row] = True
    state["budget"][row] = budget
    state["out_tokens"][row] = 0


def _admit(state, row, mini_cache, src_row, p_len, last_logits, last_hidden,
           last_token, budget) -> None:
    """Copy row ``src_row`` of a prefill mini-cache into slot ``row``
    (positions [0, bucket); a recurrent state whole, overwriting the slot's
    last request's) and arm the slot."""
    for big, mini in zip(state["cache"], mini_cache):
        big[:, row, :mini.shape[2]] = mini[:, src_row]
    _arm(state, row, p_len, last_logits[src_row], last_hidden[src_row],
         last_token, budget)


def _admit_paged(state, row, mini_cache, src_row, p_len, last_logits,
                 last_hidden, last_token, budget, tile_ids, page: int
                 ) -> None:
    """Paged admission: copy the prefilled mini-cache into pool pages and
    point slot ``row``'s block table at them.  ``tile_ids`` [s_max // page]
    covers the slot's whole logical range; entries the request does not
    need hold 0, the reserved dump page.  Pages beyond the prompt bucket
    stay as they are: decode writes each position before its window
    exposes it."""
    bucket = mini_cache[0].shape[2]
    dev = state["pos"].device
    tiles = torch.as_tensor(np.asarray(tile_ids), dtype=torch.int32,
                            device=dev)
    n_copy = bucket // page
    rows = (tiles[:n_copy, None].long() * page
            + torch.arange(page, device=dev)).reshape(-1)
    for pool, mini in zip(state["cache"], mini_cache):
        pool[:, rows] = mini[:, src_row, :n_copy * page]
    state["tables"][row] = tiles
    _arm(state, row, p_len, last_logits[src_row], last_hidden[src_row],
         last_token, budget)


@torch.no_grad()
def decode_step(model, state, gen_cfg: GenerationConfig, vocab,
                s_max: int, noise: Optional[SampleNoise] = None) -> None:
    """One decode step of every slot, in place on ``state`` (the body of
    the reference ``_decode_chunk``): every slot runs the forward, frozen
    rows compute masked garbage into their own cells (or, once harvested,
    the dump page).  ``state["steps"]`` counts the steps some row ran, so
    a step after the last running row stopped is a no-op; a sampling step
    takes its chunk's draws ``noise.at(state["steps"])``."""
    b, t = state["out_tokens"].shape
    n_img = gen_cfg.num_img_gen_tokens
    dev = state["pos"].device
    rows = torch.arange(b, device=dev)
    span = torch.arange(s_max, device=dev)
    running = state["running"]
    constrained = constrain_image_tokens(
        state["prev_token"], state["prev_logits"], vocab, n_img)
    draws = None if noise is None else noise.at(state["steps"])
    token = _sample(constrained, gen_cfg, noise=draws)
    token = torch.where(running, token, gen_cfg.pad_token_id)

    # collect (read-modify-write so frozen rows keep their cells)
    n_w = torch.clamp(state["n"], max=t - 1)
    cur_tok = state["out_tokens"][rows, n_w]
    state["out_tokens"][rows, n_w] = torch.where(running, token, cur_tok)
    cur_hid = state["out_hidden"][rows, n_w]
    state["out_hidden"][rows, n_w] = torch.where(
        running[:, None], state["prev_hidden"], cur_hid)

    ended = token == gen_cfg.eos_token_id
    n_new = torch.where(running, state["n"] + 1, state["n"])
    still = running & ~ended & (n_new < state["budget"])

    pos = state["pos"]
    kv_valid = span[None, :] <= pos[:, None]
    # a frozen row may sit at pos == s_max; its garbage write stays in
    # range (its own last row, or the dump page once harvested)
    logits, hidden, _ = model.llm_step(
        model.embed_ids(token[:, None]), pos[:, None], kv_valid,
        state["cache"], torch.clamp(pos, max=s_max - 1),
        block_tables=state.get("tables"))

    keep = running[:, None]
    _commit(state, running.any(), n=n_new, running=still,
            pos=torch.where(running, pos + 1, pos),
            prev_logits=torch.where(keep, logits[:, 0].float(),
                                    state["prev_logits"]),
            prev_hidden=torch.where(keep, hidden[:, 0],
                                    state["prev_hidden"]),
            prev_token=torch.where(running, token, state["prev_token"]))


def _commit(state, ran: torch.Tensor, **new) -> None:
    """Write a step's new values into the state's tensors in place (a
    captured program holds those tensors) and count the step if ``ran``;
    every new value was computed before any is written."""
    state["steps"].add_(ran.long())
    for name, value in new.items():
        state[name].copy_(value)


def run_chunk(program, state, k: int, noise: Optional[SampleNoise] = None,
              generator: Optional[torch.Generator] = None) -> int:
    """``k`` steps of ``program`` (a captured one on the card), then one
    host read: the steps in which some row was running (those the eager
    loop's early exit would have run).  With ``noise``, the chunk's draws
    from ``generator`` are made before it and those of its no-op steps
    given back after.

    The chunk is an ``engine.chunk`` span with its device time (its
    closing event recorded after the last replay, before the host read):
    ``kind`` (the program's), ``replayed`` (k), ``ran``, ``tokens`` (the
    row-steps that emitted a token) and ``kv_positions`` (the KV positions
    those steps read, a row's window growing by one a step), the last two
    read right after the host read of ``ran``; with sparse experts
    ``experts_active`` (the (layer, step) expert activations with rows over
    the replayed steps: the device counter's growth, resolved when the
    records are read)."""
    active = state.get("experts_active")
    with profiling.annotate("engine.chunk", device=True) as span:
        if span:
            n0, pos0 = state["n"].clone(), state["pos"].clone()
            if active is not None:
                a0 = active.clone()
        state["steps"].zero_()
        if noise is not None:
            noise.draw(generator, k)
        for _ in range(k):
            program()
        span.end_device()
        ran = int(state["steps"])
        if noise is not None:
            noise.give_back(ran)
        if span:
            d = (state["n"] - n0).clamp(min=0)
            span["tokens"], span["kv_positions"] = torch.stack(
                [d.sum(), (d * pos0 + d * (d + 1) // 2).sum()]).tolist()
            span["kind"] = program.kind
            span["replayed"], span["ran"] = k, ran
            if active is not None:
                span["experts_active"] = active - a0
    return ran


def _admit_fused(state, row: int, embeds, p_len: int, last_token: int,
                 budget: int, tile_ids=None) -> None:
    """Fused admission (reference ``_admit_fused``): write the request's
    padded prompt embeddings [1, p_pad, D] into slot ``row``'s buffer and
    arm its prefill cursor; no forward runs here.  ``tile_ids`` (paged)
    points the slot's block table at its pages, through which the mixed
    steps write the prompt's KV."""
    dev = state["pos"].device
    if tile_ids is not None:
        state["tables"][row] = torch.as_tensor(np.asarray(tile_ids),
                                               dtype=torch.int32, device=dev)
    state["prompt_embeds"][row] = embeds[0]
    state["pos"][row] = 0
    state["p_pos"][row] = 0
    state["p_len"][row] = p_len
    state["n"][row] = 0
    # the LAST PROMPT token: prefill leaves it in place, so the first
    # sampled step sees it for the constrained <img> forcing
    state["prev_token"][row] = last_token
    state["running"][row] = True
    state["budget"][row] = budget
    state["out_tokens"][row] = 0


@torch.no_grad()
def mixed_step(model, state, gen_cfg: GenerationConfig, vocab, s_max: int,
               w: int, noise: Optional[SampleNoise] = None) -> None:
    """One mixed step of every slot, in place on ``state`` (the body of
    the reference ``_mixed_chunk`` on its packed layout): decoding rows
    emit one token, prefilling rows consume prompt-buffer tokens; a row
    whose prompt completes at step i samples from step i + 1 on.  The
    step carries P = slots + w real tokens (decoding rows' tokens, then a
    w-token prompt chunk shared greedily in row order).  A step with no
    running row is a no-op (every write is dropped to a dump cell)."""
    b, t = state["out_tokens"].shape
    n_img = gen_cfg.num_img_gen_tokens
    dev = state["pos"].device
    rows = torch.arange(b, device=dev)
    span = torch.arange(s_max, device=dev)
    off = torch.arange(w, device=dev)
    running = state["running"]
    prefilling = running & (state["p_pos"] < state["p_len"])
    decoding = running & ~prefilling

    constrained = constrain_image_tokens(
        state["prev_token"], state["prev_logits"], vocab, n_img)
    draws = None if noise is None else noise.at(state["steps"])
    token = _sample(constrained, gen_cfg, noise=draws)
    token = torch.where(decoding, token, gen_cfg.pad_token_id)

    # collect (read-modify-write so non-decoding rows keep their cells)
    n_w = torch.clamp(state["n"], max=t - 1)
    cur_tok = state["out_tokens"][rows, n_w]
    state["out_tokens"][rows, n_w] = torch.where(decoding, token, cur_tok)
    cur_hid = state["out_hidden"][rows, n_w]
    state["out_hidden"][rows, n_w] = torch.where(
        decoding[:, None], state["prev_hidden"], cur_hid)

    ended = token == gen_cfg.eos_token_id
    n_new = torch.where(decoding, state["n"] + 1, state["n"])
    still = torch.where(decoding,
                        decoding & ~ended & (n_new < state["budget"]),
                        running)

    pos = state["pos"]
    left = state["p_len"] - state["p_pos"]
    # the prompt chunk: w tokens shared greedily in row order (the
    # host's _prefill_remaining replays this rule exactly)
    need = torch.where(prefilling, torch.clamp(left, max=w), 0)
    cum = torch.cumsum(need, 0)
    alloc = torch.minimum(torch.clamp(w - (cum - need), min=0), need)
    w_valid = torch.where(decoding, 1, alloc)
    acum = torch.cumsum(alloc, 0)
    # prompt token o belongs to the first row whose acum exceeds o
    r_j = torch.searchsorted(acum, off, right=True)
    valid_p = off < acum[-1]
    r_c = torch.clamp(r_j, max=b - 1)
    slot_p = off - (acum[r_c] - alloc[r_c])
    emb_p = state["prompt_embeds"][r_c, state["p_pos"][r_c] + slot_p]
    embeds = torch.cat([model.embed_ids(token).to(emb_p.dtype),
                        emb_p])                          # [P, D]
    tok_row = torch.cat([torch.where(decoding, rows, b),
                         torch.where(valid_p, r_j, b)])
    tok_slot = torch.cat([torch.zeros_like(rows), slot_p])
    positions = pos[torch.clamp(tok_row, max=b - 1)] + tok_slot
    kv_valid = span[None, :] <= (pos + w_valid - 1)[:, None]
    logits, hidden, _ = model.llm_step(
        embeds, positions, kv_valid, state["cache"], pos,
        block_tables=state.get("tables"), write_widths=w_valid,
        tok_row=tok_row, tok_slot=tok_slot, packed_window=w)
    # each row's LAST token: a decoding row's sole token sits at
    # packed index row, a prefilling row's chunk ends at
    # b + acum - 1; rows given no token gather what `active` masks
    last = torch.clamp(torch.where(decoding, rows, b + acum - 1), 0,
                       b + w - 1)
    last_logits, last_hidden = logits[last], hidden[last]
    active = decoding | (prefilling & (alloc > 0))
    keep = active[:, None]
    _commit(state, running.any(), n=n_new, running=still, pos=pos + w_valid,
            p_pos=state["p_pos"] + torch.where(prefilling, w_valid, 0),
            prev_logits=torch.where(keep, last_logits.float(),
                                    state["prev_logits"]),
            prev_hidden=torch.where(keep, last_hidden, state["prev_hidden"]),
            prev_token=torch.where(decoding, token, state["prev_token"]))


class ContinuousEngine:
    """Rolling-admission decode over a fixed slot pool.

    Usage::

        eng = ContinuousEngine(rt, slots=8, max_new_tokens=256)
        ids = [eng.submit(req) for req in requests]   # generate_batch schema
        results = eng.run()                           # {id: result dict}

    ``submit`` may also be called between ``eng.step()`` calls: requests
    admit into slots as they free.
    """

    def __init__(self, rt, slots: int = 8, max_new_tokens: int = 256,
                 chunk_steps: int = 16,
                 prompt_buckets=(128, 256, 512, 1024),
                 do_sample: bool = False, temperature: float = 0.7,
                 top_p: float = 0.5, seed: int = 0,
                 paged: bool = False, page_size: int = 128,
                 pool_tokens: int = 0, fused_prefill: bool = False,
                 prefill_width: int = 8):
        """``paged=True`` replaces the dense per-slot KV reservation
        (slots x (max bucket + max_new_tokens) rows) with a shared pool of
        ``page_size``-row pages and per-slot block tables; ``pool_tokens``
        (default: the dense footprint) sizes it.  Needs an int4 agent with
        ``decode_attention`` on (the ragged kernel reads the pages).

        ``fused_prefill`` interleaves prompt prefill into the decode chunks,
        ``prefill_width`` prompt tokens a step (see the module docstring),
        instead of a bucket prefill on admission; off by default, as in the
        JAX package.  It composes with ``paged``."""
        llm = rt.agent.cfg.llm
        if paged:
            llm.refuse("paged KV")
        if fused_prefill:
            llm.refuse("fused prefill")
        self.rt = rt
        self.model = rt.agent
        self.vocab = rt.tokenizer.vocab
        self.gen_cfg = GenerationConfig(
            max_new_tokens=max_new_tokens,
            num_img_gen_tokens=rt.agent_cfg.num_img_out_tokens,
            eos_token_id=rt.tokenizer.eos_token_id,
            pad_token_id=rt.tokenizer.pad_token_id,
            prompt_buckets=tuple(prompt_buckets),
            do_sample=do_sample, temperature=temperature, top_p=top_p)
        self.slots = slots
        self.chunk_steps = chunk_steps
        self._pending: List[tuple] = []     # (req_id, request, budget)
        self._slot_req: List[Optional[int]] = [None] * slots
        self._results: Dict[int, Dict[str, Any]] = {}
        self._count = 0
        self._completed = 0
        self._generated_tokens = 0
        self._chunks = 0
        self._steps = 0
        self._mixed_chunks = 0
        self._mixed_steps = 0
        self._programs: Dict[str, Any] = {}
        # request id -> ns of its submission, kept while recording (the
        # request.queued spans)
        self._queued_at: Dict[int, int] = {}

        cfg = self.model.cfg.llm
        dev = next(self.model.buffers()).device
        self.device = dev
        self._generator = self._noise = None
        if do_sample:
            self._generator = torch.Generator(device=dev)
            self._generator.manual_seed(seed)
            self._noise = SampleNoise(slots, cfg.padded_vocab_size,
                                      chunk_steps, dev)
        t = max_new_tokens
        s_max = max(self.gen_cfg.prompt_buckets) + t
        self._s_max = s_max
        self.paged = paged
        self.fused = fused_prefill
        self.prefill_width = prefill_width
        # host mirror of each slot's prompt tokens still to prefill (exact:
        # step() replays the device's allocation rule)
        self._prefill_remaining = [0] * slots
        if paged:
            if cfg.quantization != "int4" or cfg.decode_attention == "never":
                raise ValueError("paged KV requires quantization='int4' "
                                 "with decode_attention on")
            if s_max % page_size or any(b % page_size
                                        for b in self.gen_cfg.prompt_buckets):
                raise ValueError("page_size must divide every prompt bucket "
                                 "and max bucket + max_new_tokens")
            self.page = page_size
            n_tiles = max(pool_tokens or slots * s_max, 2 * page_size
                          ) // page_size
            self._pool_tiles = n_tiles
            # tile 0 is the reserved dump target for unused copy slots
            self._free_tiles = list(range(1, n_tiles))
            self._slot_tiles: List[Optional[list]] = [None] * slots
            cache = init_paged_kv_pool(cfg, n_tiles * page_size, device=dev,
                                       kv_heads=rt.agent.llm.kv_heads)
        else:
            cache = init_kv_cache(cfg, slots, s_max, device=dev,
                                  kv_heads=rt.agent.llm.kv_heads)
        i64 = dict(dtype=torch.int64, device=dev)
        self.state = {
            "cache": cache,
            "pos": torch.zeros((slots,), **i64),
            "n": torch.zeros((slots,), **i64),
            "prev_logits": torch.zeros((slots, cfg.padded_vocab_size),
                                       dtype=torch.float32, device=dev),
            "prev_hidden": torch.zeros((slots, cfg.hidden_size),
                                       dtype=cfg.dtype, device=dev),
            "prev_token": torch.full((slots,), self.gen_cfg.pad_token_id,
                                     **i64),
            "running": torch.zeros((slots,), dtype=torch.bool, device=dev),
            "budget": torch.full((slots,), t, **i64),
            "out_tokens": torch.zeros((slots, t), **i64),
            "out_hidden": torch.zeros((slots, t, cfg.hidden_size),
                                      dtype=cfg.dtype, device=dev),
            "steps": torch.zeros((), **i64),
        }
        if cfg.moe:
            # the model's counter (a buffer the decode step adds to)
            self.state["experts_active"] = rt.agent.llm.layers.experts_active
        if paged:
            self.state["tables"] = torch.zeros(
                (slots, s_max // page_size), dtype=torch.int32, device=dev)
        if self.fused:
            # + prefill_width rows: a window read past a prompt's end stays
            # inside the buffer (those slots are discarded)
            self._p_pad = max(self.gen_cfg.prompt_buckets) + prefill_width
            self.state["prompt_embeds"] = torch.zeros(
                (slots, self._p_pad, cfg.hidden_size), dtype=cfg.dtype,
                device=dev)
            self.state["p_pos"] = torch.zeros((slots,), **i64)
            self.state["p_len"] = torch.zeros((slots,), **i64)

    def warmup(self, buckets=None):
        """Warm the admission grid: one batched prefill AND one admit per
        (power-of-two admission batch <= slots) x (prompt bucket), then the
        decode step captured.  Without this, a live server pays each
        shape's first-call costs (library handles and workspaces, the
        kernels' one-time set-up, the allocator's first segments) and the
        capture of the step programs the first time some number of slots
        frees together.  Text-only shapes; image-carrying prompts add their
        own embed_with_images variants on first use.  Call before
        submitting (warm admits scribble on a FREE slot's inert rows --
        paged: the reserved dump page 0 -- and clear the running flag
        after).

        Fused mode needs only THREE programs regardless of bucket/batch
        shape: the prompt embed at the single padded length, the admit,
        and the mixed step (+ the pure-decode step).  Returns ``self``.
        (Reference: ``ContinuousEngine.warmup``, continuous.py:564-600;
        there the programs are XLA compiles, here CUDA graph captures.)"""
        free = next((i for i, r in enumerate(self._slot_req) if r is None),
                    None)
        if free is None:
            return self
        dummy = {"input_ids": [1, 2]}
        # all-zero table: every write resolves to the reserved dump page's
        # rows (never referenced by a live window)
        tiles = (np.zeros((self._s_max // self.page,), np.int32)
                 if self.paged else None)
        st = self.state
        if self.fused:
            _admit_fused(st, free, self._embed_prompt(dummy), 2, 2, 0,
                         tile_ids=tiles)
            self.program("mixed")()
            self.program("decode")()
            st["running"][free] = False
            st["p_len"][free] = 0
            st["p_pos"][free] = 0
            return self
        buckets = (tuple(buckets) if buckets is not None
                   else self.gen_cfg.prompt_buckets)
        limit = 1
        while limit < self.slots:      # admission batches of every power
            limit *= 2                 # of two up to the next one
        bb = 1
        while bb <= limit:
            for bucket in buckets:
                minis, lgs, lhs = self._prefill_group([dummy] * bb, bucket)
                args = (st, free, minis, 0, 2, lgs, lhs, 2, 0)
                if self.paged:
                    _admit_paged(*args, tiles, page=self.page)
                else:
                    _admit(*args)
                st["running"][free] = False
            bb *= 2
        self.program("decode")()
        return self

    # ---- submission ------------------------------------------------------

    def submit(self, request: Dict[str, Any],
               max_new_tokens: Optional[int] = None) -> int:
        """Queue a request (generate_batch schema); returns its id.
        ``max_new_tokens`` caps THIS request (<= the engine-wide budget):
        rows with small budgets free their slots early."""
        max_bucket = max(self.gen_cfg.prompt_buckets)
        if len(request["input_ids"]) > max_bucket:
            raise ValueError(
                f"prompt length {len(request['input_ids'])} exceeds the "
                f"largest prompt bucket {max_bucket}")
        rid = self._count
        self._count += 1
        budget = min(max_new_tokens or self.gen_cfg.max_new_tokens,
                     self.gen_cfg.max_new_tokens)
        if self.paged:
            n_t = self._tiles_needed(request, budget)
            if n_t > self._pool_tiles - 1:
                raise ValueError(
                    f"request needs {n_t} KV tiles but the pool has "
                    f"{self._pool_tiles - 1}; raise pool_tokens")
        self._pending.append((rid, request, budget))
        if profiling.enabled():
            self._queued_at[rid] = profiling.now()
        return rid

    # ---- internals -------------------------------------------------------

    def _embed_prompt(self, request):
        """One request's prompt (ids + spliced image embeddings) padded to
        the prompt buffer's length -> [1, p_pad, D] (reference
        ``_embed_prompt``)."""
        dev = self.device
        ids = np.full((1, self._p_pad), self.gen_cfg.pad_token_id, np.int64)
        p = len(request["input_ids"])
        ids[0, :p] = np.asarray(request["input_ids"], np.int64)
        cm = request.get("ids_cmp_mask")
        cmp_padded = None
        if cm is not None:
            cmp_padded = np.zeros((1, self._p_pad), bool)
            cmp_padded[0, :p] = np.asarray(cm, bool)
        image_embeds = request.get("image_embeds")
        ecm = ppos = None
        if image_embeds is not None:
            image_embeds = torch.as_tensor(image_embeds, device=dev)
            ecm = torch.as_tensor(np.asarray(request["embeds_cmp_mask"],
                                             bool), device=dev)
            pp = request.get("patch_positions")
            ppos = (torch.as_tensor(pp, dtype=torch.float32, device=dev)
                    if pp is not None else None)
        with torch.no_grad():
            return self.model.embed_with_images(
                torch.as_tensor(ids, device=dev), image_embeds,
                torch.as_tensor(cmp_padded, device=dev)
                if cmp_padded is not None else None, ecm, ppos)

    def _prefill_group(self, requests, bucket):
        """One prefill for every request of a prompt bucket; prompts are
        right-padded (every slot row starts its cache at 0).  An
        ``engine.prefill_group`` span: ``b``, ``bucket``, ``p_lens``,
        ``images`` (image embeddings spliced) and, for a hybrid stack,
        ``ssm_tokens`` (the real prompt tokens, each through every Mamba
        block: its ``llm.ssm_scan`` children)."""
        with profiling.annotate("engine.prefill_group") as span:
            if span:
                span["b"], span["bucket"] = len(requests), bucket
                p_lens = [len(r["input_ids"]) for r in requests]
                span["p_lens"] = p_lens
                if self.model.cfg.llm.hybrid:
                    span["ssm_tokens"] = sum(p_lens)
                span["images"] = sum(int(r["image_embeds"].shape[0])
                                     for r in requests
                                     if r.get("image_embeds") is not None)
            b = len(requests)
            dev = self.device
            pad_id = self.gen_cfg.pad_token_id
            ids_padded = np.full((b, bucket), pad_id, np.int64)
            cmp_padded = np.zeros((b, bucket), bool)
            p_lens = np.ones((b,), np.int64)
            any_cmp = False
            img_parts, ecm_parts, pp_parts = [], [], []
            for i, r in enumerate(requests):
                ids = r["input_ids"]
                p = len(ids)
                ids_padded[i, :p] = np.asarray(ids, np.int64)
                p_lens[i] = p
                cm = r.get("ids_cmp_mask")
                if cm is not None:
                    cmp_padded[i, :p] = np.asarray(cm, bool)
                    any_cmp = True
                if r.get("image_embeds") is not None:
                    img_parts.append(torch.as_tensor(r["image_embeds"],
                                                     device=dev))
                    ecm_parts.append(np.asarray(r["embeds_cmp_mask"], bool))
                    pp_parts.append(r.get("patch_positions"))
            image_embeds = torch.cat(img_parts) if img_parts else None
            ecm = (torch.as_tensor(np.concatenate(ecm_parts), device=dev)
                   if ecm_parts else None)
            ppos = None
            if img_parts and any(p is not None for p in pp_parts):
                # requests without patch positions get the thumbnail's
                # center
                ppos = torch.cat([
                    torch.as_tensor(p, dtype=torch.float32, device=dev)
                    if p is not None
                    else torch.full((img.shape[0], 2), 0.5, device=dev)
                    for p, img in zip(pp_parts, img_parts)])
            with torch.no_grad():
                embeds = self.model.embed_with_images(
                    torch.as_tensor(ids_padded, device=dev), image_embeds,
                    torch.as_tensor(cmp_padded, device=dev) if any_cmp
                    else None, ecm, ppos)
            return _prefill(self.model, embeds,
                            torch.as_tensor(p_lens, device=dev), bucket)

    def _tiles_needed(self, request, budget) -> int:
        return -(-(len(request["input_ids"]) + budget) // self.page)

    def _admit_pending(self):
        """Admit what the free slots (and, paged, the page pool) can take:
        an ``engine.admit`` span (``admitted``).  A request taken ends its
        ``request.queued`` span (``p_len``, ``budget``)."""
        with profiling.annotate("engine.admit") as span:
            free = [i for i, r in enumerate(self._slot_req) if r is None]
            take = self._take_pending(len(free))
            span["admitted"] = len(take)
            if self._queued_at:
                for rid, request, budget in take:
                    t0 = self._queued_at.pop(rid, None)
                    if t0 is not None:
                        with profiling.annotate(
                                "request.queued", rid=rid, start=t0,
                                p_len=len(request["input_ids"]),
                                budget=budget):
                            pass
            self._admit_taken(take, free)

    def _take_pending(self, n_free: int) -> list:
        """Take up to ``n_free`` pending requests in order (paged: those
        the page pool can hold; the rest wait)."""
        if not n_free or not self._pending:
            return []
        take, self._pending = (self._pending[:n_free],
                               self._pending[n_free:])
        if self.paged:
            # best-effort FCFS: defer requests the page pool can't hold yet
            # (their pages free as running slots harvest)
            admitted, deferred, avail = [], [], len(self._free_tiles)
            for item in take:
                n_t = self._tiles_needed(item[1], item[2])
                if n_t <= avail:
                    avail -= n_t
                    admitted.append(item)
                else:
                    deferred.append(item)
            self._pending = deferred + self._pending
            take = admitted
        return take

    def _admit_taken(self, take: list, free: List[int]) -> None:
        """Put each taken request into a free slot: a prompt-buffer write
        (fused), or a bucket prefill of each bucket's requests."""
        if self.fused:
            # admission is a prompt-buffer write; the mixed chunks prefill
            for rid, request, budget in take:
                row = free.pop(0)
                p_len = len(request["input_ids"])
                _admit_fused(self.state, row, self._embed_prompt(request),
                             p_len, int(request["input_ids"][-1]), budget,
                             self._allocate_tiles(row, request, budget)
                             if self.paged else None)
                self._slot_req[row] = rid
                self._prefill_remaining[row] = p_len
            return
        by_bucket: Dict[int, list] = {}
        for item in take:
            p_len = len(item[1]["input_ids"])
            bucket = next((x for x in self.gen_cfg.prompt_buckets
                           if x >= p_len), p_len)
            by_bucket.setdefault(bucket, []).append(item)
        for bucket, items in by_bucket.items():
            minis, lgs, lhs = self._prefill_group([r for _, r, _ in items],
                                                  bucket)
            for j, (rid, request, budget) in enumerate(items):
                row = free.pop(0)
                args = (self.state, row, minis, j, len(request["input_ids"]),
                        lgs, lhs, int(request["input_ids"][-1]), budget)
                if self.paged:
                    _admit_paged(*args, self._allocate_tiles(row, request,
                                                             budget),
                                 page=self.page)
                else:
                    _admit(*args)
                self._slot_req[row] = rid

    def _allocate_tiles(self, row: int, request, budget: int) -> np.ndarray:
        """Take the pages slot ``row``'s request needs; returns its block
        table row (unused entries 0, the dump page)."""
        n_t = self._tiles_needed(request, budget)
        tiles = [self._free_tiles.pop() for _ in range(n_t)]
        self._slot_tiles[row] = tiles
        ids = np.zeros((self._s_max // self.page,), np.int32)
        ids[:n_t] = tiles
        return ids

    def _harvest(self):
        """Collect the results of the rows that stopped: an
        ``engine.harvest`` span (``harvested``)."""
        with profiling.annotate("engine.harvest") as span:
            span["harvested"] = self._collect()

    def _collect(self) -> int:
        """Build the stopped rows' results and free their slots; returns
        the number collected."""
        running = self.state["running"].cpu().numpy()
        done_rows = [i for i, rid in enumerate(self._slot_req)
                     if rid is not None and not running[i]]
        if not done_rows:
            return 0
        n = self.state["n"].cpu().numpy()
        # a copy: on the CPU .numpy() would alias the live state, which the
        # slot's next request overwrites
        out_tokens = self.state["out_tokens"].cpu().numpy().copy()
        n_img = self.gen_cfg.num_img_gen_tokens
        span_list = []
        rows_meta = []
        for i in done_rows:
            tokens, eoi = _trim_and_spans(out_tokens[i, :n[i]], self.gen_cfg,
                                          self.vocab)
            rows_meta.append((i, tokens, eoi))
            span_list.extend((i, j) for j in eoi)
        img_gen_all = None
        if span_list:
            spans = torch.stack([self.state["out_hidden"][i, j - n_img:j]
                                 for i, j in span_list])
            with torch.no_grad():
                img_gen_all = self.model.decode_image_feats(spans)
        consumed = 0
        for i, tokens, eoi in rows_meta:
            feat = None
            if eoi:
                feat = img_gen_all[consumed:consumed + len(eoi)]
                consumed += len(eoi)
            self._results[self._slot_req[i]] = build_result(
                tokens, eoi, feat, self.rt.tokenizer, self.vocab, n_img)
            self._slot_req[i] = None
            self._completed += 1
            self._generated_tokens += len(tokens)
            if self.paged and self._slot_tiles[i]:
                self._free_tiles.extend(self._slot_tiles[i])
                self._slot_tiles[i] = None
        if self.paged:
            # retarget harvested rows at the dump page: a frozen slot keeps
            # issuing (masked-garbage) KV writes every chunk, and its freed
            # pages may go to a live request before this slot is re-admitted
            self.state["tables"][done_rows] = 0
        return len(done_rows)

    # ---- driving ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Engine counters (host values only: reading them never waits on
        the device)."""
        out = {"submitted": self._count,
               "pending": len(self._pending),
               "active_slots": sum(r is not None for r in self._slot_req),
               "slots": self.slots,
               "completed": self._completed,
               "generated_tokens": self._generated_tokens,
               "chunks": self._chunks,
               "decode_steps": self._steps,
               "mixed_chunks": self._mixed_chunks,
               "mixed_steps": self._mixed_steps}
        if self.paged:
            out["kv_tiles_free"] = len(self._free_tiles)
            out["kv_tiles_total"] = self._pool_tiles - 1
        return out

    def step(self) -> int:
        """Admit -> one decode chunk -> harvest.  Returns #results ready.
        An ``engine.step`` span (``pending``, ``active``: at entry)."""
        with profiling.annotate("engine.step") as span:
            if span:
                span["pending"] = len(self._pending)
                span["active"] = sum(r is not None for r in self._slot_req)
            self._admit_pending()
            if any(r is not None for r in self._slot_req):
                if self.fused and any(self._prefill_remaining):
                    # a slot is mid-prompt: the mixed (prefill + decode)
                    # chunk
                    n = run_chunk(self.program("mixed"), self.state,
                                  self.chunk_steps, self._noise,
                                  self._generator)
                    self._replay_prefill(n)
                    self._mixed_steps += n
                    self._mixed_chunks += 1
                else:
                    self._steps += run_chunk(
                        self.program("decode"), self.state,
                        self.chunk_steps, self._noise, self._generator)
                self._chunks += 1
            self._harvest()
        return len(self._results)

    def program(self, kind: str):
        """The engine's one-step program of ``kind`` ("decode" or "mixed")
        over its state: captured at its first call on the card (or at
        ``warmup``), replayed after (``utils/graphs.py``)."""
        prog = self._programs.get(kind)
        if prog is None:
            if kind == "decode":
                def fn():
                    decode_step(self.model, self.state, self.gen_cfg,
                                self.vocab, self._s_max, self._noise)
            elif kind == "mixed" and self.fused:
                def fn():
                    mixed_step(self.model, self.state, self.gen_cfg,
                               self.vocab, self._s_max, self.prefill_width,
                               self._noise)
            else:
                raise ValueError(f"no {kind!r} program in this engine")
            prog = Program(fn, self.device, self.model.graphs, kind=kind)
            self._programs[kind] = prog
        return prog

    def _replay_prefill(self, steps: int) -> None:
        """The device's prompt consumption over ``steps`` mixed steps,
        replayed on the host (reference ``step()``, continuous.py:890-920):
        each step shares ``prefill_width`` tokens across the prefilling
        slots in row order."""
        rem = self._prefill_remaining
        for _ in range(steps):
            budget = self.prefill_width
            for r in range(len(rem)):
                take = min(rem[r], budget)
                rem[r] -= take
                budget -= take

    def run(self) -> Dict[int, Dict[str, Any]]:
        """Drain the queue; returns {request_id: result}."""
        while self._pending or any(r is not None for r in self._slot_req):
            before_pending = len(self._pending)
            before_chunks = self._chunks
            self.step()
            if (len(self._pending) == before_pending and before_pending
                    and self._chunks == before_chunks):
                # nothing admitted AND nothing ran: the pool can never
                # satisfy the head request (submit() bounds single
                # requests, so this is sizing/fragmentation)
                raise RuntimeError(
                    "paged KV pool too small to admit pending requests")
        out, self._results = self._results, {}
        return out
