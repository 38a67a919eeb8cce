"""Continuous batching: requests join and leave the decode batch
mid-flight (counterpart of `visionllm_tpu/slots.py`; one static KV region
per slot, no paging).

The decode batch is a set of SLOTS with independent fill levels:

* `prefill(input_ids, images, attn_mask)`: one request's prompt through
  the full vision + LLM prefill (left-padded to the service's length),
  returning its first token, next-step embedding and a one-row KV cache.
* `insert(state, slot, ...)`: copy that row into slot `slot` of the
  multi-slot state, in place (JAX donates the buffers and returns new
  ones).
* `step(state, slot_valid)`: ONE token for every live slot. Where JAX
  `jax.vmap`s the scalar-index step over slots, this is one batched
  [S, 1] forward: the cache's index is a tensor [S], so each row's
  position, K/V write and decode mask `j <= index[s]` (with the slot's
  valid mask) are its own, and every projection runs once at M = S.
  Dead slots compute too but neither advance nor surface tokens.

The slot state's cache is int8 with scales under `kv_quant="int8"`
(`VisionLLM.new_cache`), as JAX's (`slots.py:100-102`); sessions refuse
it. The tool-token state machine (`generation.advance_tool_state`) runs
per slot inside `step`. A request decoded through slots, at any arrival time
and next to any traffic, gets the tokens `build_generate_fn` gives it
alone (tests/test_torch_slots.py).

`build_chunked_prefill_fns` runs a prompt through the LLM in fixed
windows of the cached extend forward (`VisionLLM.llm_window`), so the
scheduler can decode live slots between windows; `build_session_fns`
extends a parked slot's cache with a follow-up turn's new tokens. The
host-side scheduling lives in `serve.ChatService`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.generation import (_token_logprob, _tool_kind,
                                            advance_tool_state, row_settings,
                                            sample_token)
from visionllm_tpu_torch.models.llama import KVCache
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds, VisionLLM


@dataclasses.dataclass
class SlotState:
    cache: KVCache              # index: int64 [S], per-slot fill level
    cur_embed: torch.Tensor     # [S, 1, C] next decode input per slot
    emb_countdown: torch.Tensor  # [S] int32
    emb_kind: torch.Tensor      # [S] int32
    live: torch.Tensor          # [S] bool
    temperature: Optional[torch.Tensor] = None  # [S] fp32 (0 = greedy)
    top_p: Optional[torch.Tensor] = None        # [S] fp32
    generators: Optional[list] = None  # [S] torch.Generator (sampling)


def _dtype_device(core: VisionLLM):
    w = core.llm.norm.weight
    return w.dtype, w.device


def build_slot_fns(core: VisionLLM, tid: SpecialTokenIds, *, n_slots: int,
                   max_len: int = 4096, eos_id: int = 2,
                   sampling: bool = False, span: int = 1):
    """Returns (init_state, prefill, insert, step). `step` emits one token
    per slot; the host reads them, stops slots on EOS or length and frees
    them. `span > 1` makes `step` run `span` ticks and return stacked
    `token` / `logprob` / `finished` of shape [span, S]: one host read per
    span. A slot that ends mid-span stops advancing through `live`; up to
    span - 1 tokens past a host-side length stop are computed and dropped.
    `sampling=True` adds per-slot temperature / top-p
    (`generation.sample_token`) and a generator per slot: the one its
    request's prefill drew the first token from, drawn once per tick, so
    a seeded request's tokens do not depend on its neighbours (JAX
    shares one key per state, and per-request seeds do not reproduce in a
    shared batch)."""
    cfg = core.cfg
    num_embs, num_embs_gen = cfg.num_embs, cfg.num_embs_gen
    hid = cfg.llm.hidden_size
    dtype, dev = _dtype_device(core)

    def init_state():
        """Returns (state, slot_valid): slot_valid [S, max_len] is the
        per-slot buffer mask (prompt pads stay False for the slot's
        lifetime)."""
        cache = core.new_cache(n_slots, max_len)
        cache.index = torch.zeros(n_slots, dtype=torch.long, device=dev)
        state = SlotState(
            cache=cache,
            cur_embed=torch.zeros(n_slots, 1, hid, dtype=dtype, device=dev),
            emb_countdown=torch.zeros(n_slots, dtype=torch.int32, device=dev),
            emb_kind=torch.zeros(n_slots, dtype=torch.int32, device=dev),
            live=torch.zeros(n_slots, dtype=torch.bool, device=dev))
        if sampling:
            state.temperature = torch.zeros(n_slots, device=dev)
            state.top_p = torch.ones(n_slots, device=dev)
            state.generators = [torch.Generator(dev).manual_seed(0)] \
                * n_slots
        return state, torch.ones(n_slots, max_len, dtype=torch.bool,
                                 device=dev)

    @torch.no_grad()
    def prefill(input_ids: torch.Tensor, images: Optional[torch.Tensor],
                attn_mask: Optional[torch.Tensor] = None,
                first_token: Optional[int] = None,
                generator: Optional[torch.Generator] = None,
                temperature: Optional[float] = None,
                top_p: Optional[float] = None,
                regions: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        """[1, Lp] prompt (and its `regions` [1, R, H, W] prompt masks)
        -> first token (0-d int32), its embedding [1, 1, C], its logprob,
        the one-row cache (index Lp), the buffer-valid mask [max_len]
        (prompt pads invisible forever) and, sampling, the generator it
        drew from (seed 0 when None)."""
        cache = core.new_cache(1, max_len)
        out = core(input_ids, images, tid, attn_mask=attn_mask, cache=cache,
                   regions=regions)
        last = out["logits"][:, -1, :]
        if sampling:
            if generator is None:
                generator = torch.Generator(dev).manual_seed(0)
            first = sample_token(last, generator,
                                 row_settings(temperature, 0.0, 1, dev),
                                 row_settings(top_p, 1.0, 1, dev))
        else:
            first = torch.argmax(last, dim=-1).to(torch.int32)
        if first_token is not None:
            first = torch.full_like(first, first_token)
        embed = core.embed_tokens(first[:, None].long())
        valid = torch.ones(max_len, dtype=torch.bool, device=dev)
        if attn_mask is not None:
            valid[:input_ids.shape[1]] = attn_mask[0].bool()
        return {"first": first[0], "embed": embed,
                "logprob": _token_logprob(last, first)[0],
                "cache": cache, "valid": valid, "generator": generator}

    @torch.no_grad()
    def insert(state: SlotState, slot: int, first: torch.Tensor,
               embed: torch.Tensor, row_cache: KVCache, valid: torch.Tensor,
               slot_valid: torch.Tensor, temperature: float = 0.0,
               top_p: float = 1.0,
               generator: Optional[torch.Generator] = None):
        """Copy a prefilled request into slot `slot`, in place; a sampling
        slot draws from `generator` from now on (when given). Returns
        (state, slot_valid)."""
        c = state.cache
        c.k[:, slot] = row_cache.k[:, 0]
        c.v[:, slot] = row_cache.v[:, 0]
        if c.k_scale is not None:
            c.k_scale[:, slot] = row_cache.k_scale[:, 0]
            c.v_scale[:, slot] = row_cache.v_scale[:, 0]
        c.index[slot] = row_cache.index
        kind0 = _tool_kind(first, tid)
        total0 = torch.where(kind0 >= C.TOOL_GEN, num_embs_gen, num_embs)
        state.cur_embed[slot] = embed[0].to(state.cur_embed.dtype)
        state.emb_countdown[slot] = torch.where(kind0 > 0, total0, 0)
        state.emb_kind[slot] = kind0
        state.live[slot] = first != eos_id
        if sampling:
            state.temperature[slot] = temperature
            state.top_p[slot] = top_p
            if generator is not None:
                state.generators[slot] = generator
        slot_valid[slot] = valid
        return state, slot_valid

    @torch.no_grad()
    def step1(state: SlotState, slot_valid: torch.Tensor) -> Dict[str, Any]:
        """One token for every slot: `token` [S] (0 on dead slots),
        `logprob` [S], `hidden` [S, C] fp32, `finished` [S] (newly
        ended). The state is updated in place."""
        c = state.cache
        index = c.index
        res = core.llm_step(state.cur_embed, index[:, None], c, slot_valid)
        logits = res["logits"][:, -1, :]
        if sampling:
            sampled = sample_token(logits, state.generators,
                                   state.temperature, state.top_p)
        else:
            sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        forcing = state.emb_countdown > 0
        next_token, next_embed, countdown, kind = advance_tool_state(
            core, tid, num_embs, num_embs_gen, sampled, state.emb_countdown,
            state.emb_kind)
        ended = (~forcing) & (sampled == eos_id)
        live = state.live
        # dead slots do not advance: their garbage writes land on the same
        # masked position until the slot is reused
        c.index = torch.where(live, index + 1, index)
        state.cur_embed = next_embed
        state.emb_countdown = torch.where(live, countdown,
                                          state.emb_countdown)
        state.emb_kind = torch.where(live, kind, state.emb_kind)
        state.live = live & ~ended
        return {"state": state,
                "token": torch.where(live, next_token, 0),
                "hidden": res["hidden"][:, -1, :].float(),
                "logprob": torch.where(
                    live, _token_logprob(logits, next_token), 0.0),
                "finished": live & ended}

    def step_span(state: SlotState, slot_valid: torch.Tensor
                  ) -> Dict[str, Any]:
        """`span` ticks; `token`, `logprob`, `finished` stacked [span, S]."""
        outs = [step1(state, slot_valid) for _ in range(span)]
        return {"state": state,
                **{k: torch.stack([o[k] for o in outs])
                   for k in ("token", "logprob", "finished")}}

    return init_state, prefill, insert, (step_span if span > 1 else step1)


def _llm_window(core: VisionLLM, emb_chunk: torch.Tensor, cache_row: KVCache,
                valid_row: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One cached extend window of a one-row cache (chunked prefill,
    session extension): positions continue from the row's fill index."""
    pos = (cache_row.index + torch.arange(emb_chunk.shape[1],
                                          device=emb_chunk.device))[None]
    return core.llm_window(emb_chunk, pos, cache_row, valid_row[None])


def _greedy_finish(core: VisionLLM):
    """last_logits [1, V] -> (first token [1] int32, its embedding
    [1, 1, C], its logprob): the shared admission tail after the last
    prefill or extend window."""

    @torch.no_grad()
    def finish(last_logits: torch.Tensor):
        first = torch.argmax(last_logits, dim=-1).to(torch.int32)
        embed = core.embed_tokens(first[:, None].long())
        return first, embed, _token_logprob(last_logits, first)[0]

    return finish


def build_session_fns(core: VisionLLM):
    """Session (multi-turn prefix) KV reuse: a finished chat turn's slot
    KV is parked, and the follow-up turn runs only its NEW tokens (the
    delta after the cached prefix) through the cached extend window,
    skipping the re-prefill of the conversation and its vision encode.

    The delta is right-padded to the service's window width; after each
    window the row's fill index is rolled BACK over the pads, so the next
    write overwrites their K/V before any position above the fill index
    becomes attendable (`j <= index`), and positions stay gap-free: the
    extension computes what a prefill of the whole history computes.

    Returns (extract_row, embed_delta, extend_window, finish, kill):
      * extract_row(state, slot_valid, slot) -> (row_cache, valid_row):
        a copy of a parked slot's cache and valid mask;
      * embed_delta(ids [1, E]) -> plain token embeddings (the host
        guards that the delta has no image, region or [EMB] token);
      * extend_window(emb [1, W, C], row_cache, valid_row, n_real) ->
        (row_cache, last_logits [1, V]): one window, in place;
        `last_logits` is row n_real - 1, the last real token;
      * finish(last_logits) -> (first [1], embed, logprob);
      * kill(state, slot): mark a slot dead so a parked (length-stopped)
        slot stops advancing.

    An int8 KV cache is refused with JAX's ValueError: the extend window
    reads the cache back, which drifts from a monolithic prefill."""
    if core.cfg.llm.kv_quant == "int8":
        raise ValueError(
            "session reuse requires an exact (non-quantized) KV cache: "
            "the extend window reads the cache back, and int8 "
            "requantization would drift from monolithic prefill")

    @torch.no_grad()
    def extract_row(state: SlotState, slot_valid: torch.Tensor, slot: int):
        c = state.cache
        row = KVCache(c.k[:, slot:slot + 1].clone(),
                      c.v[:, slot:slot + 1].clone(), int(c.index[slot]))
        return row, slot_valid[slot].clone()

    @torch.no_grad()
    def embed_delta(delta_ids: torch.Tensor) -> torch.Tensor:
        return core.embed_tokens(delta_ids)

    @torch.no_grad()
    def extend_window(emb_chunk: torch.Tensor, cache_row: KVCache,
                      valid_row: torch.Tensor, n_real: int):
        out = _llm_window(core, emb_chunk, cache_row, valid_row)
        # roll the fill index back over the window's right-pads
        cache_row.index -= emb_chunk.shape[1] - n_real
        return cache_row, out["logits"][:, n_real - 1]

    def kill(state: SlotState, slot: int) -> SlotState:
        state.live[slot] = False
        return state

    return extract_row, embed_delta, extend_window, _greedy_finish(core), kill


def build_chunked_prefill_fns(core: VisionLLM, tid: SpecialTokenIds, *,
                              chunk: int, max_len: int = 4096):
    """Chunked prefill: a prompt runs through the LLM in fixed `chunk`-token
    windows so the scheduler can decode the live slots between windows,
    bounding the stall an admission causes to about one window. The
    window is the cached extend forward, which on an initially empty
    cache is the prefill's attention, so chunked equals monolithic up to
    the order of the sums (the einsum branch instead of the flash
    kernel).

    Returns (new_row_cache, embed_prompt, prefill_chunk, finish):
      * new_row_cache() -> an empty one-row cache (index 0);
      * embed_prompt(ids [1, Lp], images, regions=None) -> the multimodal
        embedding assembly (vision encode, region encode and scatters),
        Lp a multiple of `chunk`;
      * prefill_chunk(emb_chunk [1, chunk, C], cache_row, valid_row) ->
        (cache_row, last_logits [1, V]): one window, in place;
      * finish(last_logits) -> (first [1], embed [1, 1, C], logprob)."""

    def new_row_cache() -> KVCache:
        return core.new_cache(1, max_len)

    @torch.no_grad()
    def embed_prompt(input_ids: torch.Tensor, images: Optional[torch.Tensor],
                     regions: Optional[torch.Tensor] = None) -> torch.Tensor:
        return core.build_prompt_embeds(input_ids, images, tid,
                                        regions=regions)[0]

    @torch.no_grad()
    def prefill_chunk(emb_chunk: torch.Tensor, cache_row: KVCache,
                      valid_row: torch.Tensor):
        out = _llm_window(core, emb_chunk, cache_row, valid_row)
        return cache_row, out["logits"][:, -1]

    return new_row_cache, embed_prompt, prefill_chunk, _greedy_finish(core)
