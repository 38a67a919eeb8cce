"""Autoregressive generation with super-link tool routing.

Counterpart of `visionllm_tpu/generation.py` (`sample_token`,
`build_generate_fn` greedy and with `sampling=True`, `advance_tool_state`,
`build_speculative_generate_fn`, `extract_tool_queries_from_generation`).
When the LLM emits a tool token ([DET]/[GRD]/[SEG]/[POSE]/[GEN]/[EDIT]),
the next 4 (perception) or 64 (generation) inputs are the tool's
learnable [EMB] rows and the matching [EMB] ids are emitted: the
emb-countdown state machine. The JAX `lax.while_loop` becomes a Python
loop over a preallocated state with the same bookkeeping: `step` starts at
1 after the prefill, `out_hidden[step - 1]` holds the hidden state of the
token emitted at step - 1, and the loop runs while `step < max_new` and
some row is not done (one host sync per step reads that test).

Sampling draws from an explicit `torch.Generator` on the logits' device
(Gumbel-max over the filtered logits), one draw for the first token and
one per step, as JAX splits its key. It cannot reproduce `jax.random`'s
bits: the same seed gives the same tokens in the port, not JAX's tokens.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.config import VisionLLMConfig
from visionllm_tpu_torch.models.visionllm import (SpecialTokenIds, VisionLLM,
                                                  compact_masked_rows,
                                                  tool_context)


def _token_logprob(logits: torch.Tensor, token: torch.Tensor) -> torch.Tensor:
    """log softmax of `logits` [B, V] at `token` [B] -> [B] fp32."""
    lp = F.log_softmax(logits.float(), dim=-1)
    return torch.gather(lp, -1, token[:, None].long())[:, 0]


def nucleus_filter(scaled: torch.Tensor, top_p: torch.Tensor
                   ) -> torch.Tensor:
    """JAX's nucleus filter of `sample_token` on [B, V] logits: over a
    stable descending sort (ties keep index order, as `jnp.argsort` of
    the negated logits), keep the smallest prefix whose probability mass
    reaches `top_p[b]` (the first token always kept), the rest -inf."""
    order = torch.argsort(-scaled, dim=-1, stable=True)
    s_sorted = torch.gather(scaled, -1, order)
    probs = torch.softmax(s_sorted, dim=-1)
    csum = torch.cumsum(probs, dim=-1)
    keep = (csum - probs) < top_p[:, None]
    s_sorted = s_sorted.masked_fill(~keep, float("-inf"))
    return torch.empty_like(scaled).scatter_(-1, order, s_sorted)


def sample_token(logits: torch.Tensor, generator, temperature: torch.Tensor,
                 top_p: torch.Tensor) -> torch.Tensor:
    """Per-row temperature / nucleus sampling over [B, V] logits
    (`generation.py:55-83` of the JAX package): `temperature[b] <= 0`
    is greedy for that row; rows with `top_p[b] < 1` draw from their
    nucleus (`nucleus_filter`). One Gumbel-max draw per row from
    `generator`, a `torch.Generator` or a sequence of B of them (one per
    row, so a row's draws do not depend on the other rows). JAX filters
    every row of a batch once any row has top_p < 1 (deciding that on the
    host would cost a sync here); a row with top_p >= 1 is left
    unfiltered, which differs only by the tail tokens whose preceding
    mass rounds to 1."""
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    scaled = logits / temperature.float().clamp(min=1e-6)[:, None]
    scaled = torch.where((top_p < 1.0)[:, None],
                         nucleus_filter(scaled, top_p.float()), scaled)
    if isinstance(generator, torch.Generator):
        expo = torch.empty_like(scaled).exponential_(generator=generator)
    else:
        expo = torch.stack([torch.empty_like(scaled[0]).exponential_(
            generator=g) for g in generator])
    drawn = torch.argmax(scaled - expo.log(), dim=-1).to(torch.int32)
    return torch.where(temperature <= 0.0, greedy, drawn)


def _tool_kind(token: torch.Tensor, tid: SpecialTokenIds) -> torch.Tensor:
    kind = torch.zeros_like(token)
    for ids, code in (((tid.det, tid.seg, tid.grd), C.TOOL_DET),
                      ((tid.pose,), C.TOOL_POSE),
                      ((tid.gen,), C.TOOL_GEN),
                      ((tid.edit,), C.TOOL_EDIT)):
        for t in ids:
            kind = torch.where(token == t, torch.full_like(kind, code), kind)
    return kind


def advance_tool_state(core: VisionLLM, tid: SpecialTokenIds, num_embs: int,
                       num_embs_gen: int, sampled: torch.Tensor,
                       countdown: torch.Tensor, kind: torch.Tensor):
    """One step of the emb-countdown tool state machine: given the sampled
    token and the per-row (countdown, kind), pick the emitted token
    (forced [EMB] id while counting down), its next-step input embedding
    (tool table row or vocab embedding) and the updated (countdown, kind).

    Returns (next_token [B], next_embed [B, 1, C], countdown', kind')."""
    forcing = countdown > 0
    gen_like = kind >= C.TOOL_GEN
    total = torch.where(gen_like, torch.full_like(countdown, num_embs_gen),
                        torch.full_like(countdown, num_embs))
    offset = total - countdown
    # perception embs have distinct ids [EMB]..[EMB4]; gen/edit repeat [EMB]
    forced_token = torch.where(gen_like, torch.full_like(offset, tid.emb),
                               tid.emb + offset)
    next_token = torch.where(forcing, forced_token, sampled)

    next_embed = core.embed_tokens(next_token[:, None].long())
    for code, table in ((C.TOOL_DET, core.emb_embeddings_det),
                        (C.TOOL_POSE, core.emb_embeddings_pose),
                        (C.TOOL_GEN, core.emb_embeddings_gen),
                        (C.TOOL_EDIT, core.emb_embeddings_edit)):
        row = table[offset.clamp(0, table.shape[0] - 1)]          # [B, C]
        use = forcing & (kind == code)
        next_embed = torch.where(use[:, None, None],
                                 row[:, None, :].to(next_embed.dtype),
                                 next_embed)

    # countdown bookkeeping: start on a sampled tool token, else decrement
    new_kind = _tool_kind(sampled, tid)
    started = (~forcing) & (new_kind > 0)
    start_total = torch.where(new_kind >= C.TOOL_GEN,
                              torch.full_like(new_kind, num_embs_gen),
                              torch.full_like(new_kind, num_embs))
    zero = torch.zeros_like(countdown)
    new_countdown = torch.where(forcing, countdown - 1,
                                torch.where(started, start_total, zero))
    kind_out = torch.where(forcing, kind,
                           torch.where(started, new_kind, zero))
    return next_token, next_embed, new_countdown, kind_out


def row_settings(value, default: float, B: int, device) -> torch.Tensor:
    """A per-row fp32 [B] setting from a scalar or [B] value (None ->
    `default`), as JAX broadcasts `temperature` and `top_p`."""
    if value is None:
        value = default
    return torch.as_tensor(value, dtype=torch.float32,
                           device=device).expand(B).clone()


def build_generate_fn(core: VisionLLM, tid: SpecialTokenIds, *,
                      max_new_tokens: int = 256, eos_id: int = 2,
                      max_len: int = 4096, sampling: bool = False):
    """Returns the `generate(input_ids, images, first_token=None,
    attn_mask=None, live=None, regions=None)` closure of the JAX
    `build_generate_fn`.

    input_ids [B, L]; images [N, H, W, 3] or [B, T, H, W, 3] or None;
    `regions` [B, R, H, W] visual-prompt masks condition the prefill
    through the region encoder (`VisionLLM.build_prompt_embeds`);
    `first_token` [B] overrides the first sampled token; `attn_mask`
    [B, L] marks valid prompt tokens of LEFT-padded batches (pads are
    excluded from attention in prefill and decode); `live` [B] marks real
    rows (dead rows start done). `sampling=True` adds the `generator`
    (a `torch.Generator` on the device; seed 0 when None), `temperature`
    and `top_p` arguments (scalars or per row [B]; temperature 0 is greedy
    for its row). Returns dict(out_tokens [B, max_new] int32, out_hidden
    [B, max_new, C] fp32, out_logprobs [B, max_new] fp32, num_generated
    int, cache)."""
    cfg = core.cfg
    num_embs, num_embs_gen = cfg.num_embs, cfg.num_embs_gen

    @torch.no_grad()
    def generate(input_ids: torch.Tensor, images: Optional[torch.Tensor],
                 first_token: Optional[torch.Tensor] = None,
                 attn_mask: Optional[torch.Tensor] = None,
                 live: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 temperature=None, top_p=None,
                 regions: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        B, L = input_ids.shape
        dev = input_ids.device
        cache = core.new_cache(B, max_len)
        out = core(input_ids, images, tid, attn_mask=attn_mask, cache=cache,
                   regions=regions)
        last = out["logits"][:, -1, :]
        if sampling:
            if generator is None:
                generator = torch.Generator(dev).manual_seed(0)
            temperature = row_settings(temperature, 0.0, B, dev)
            top_p = row_settings(top_p, 1.0, B, dev)

        def pick(logits):
            if sampling:
                return sample_token(logits, generator, temperature, top_p)
            return torch.argmax(logits, dim=-1).to(torch.int32)

        first = pick(last)
        if first_token is not None:
            first = torch.as_tensor(first_token, dtype=torch.int32,
                                    device=dev).expand(B).clone()
        cur_embed = core.embed_tokens(first[:, None].long())

        decode_mask = None
        if attn_mask is not None:
            # prompt pads stay invisible; every slot decode writes is valid
            decode_mask = torch.cat(
                [attn_mask.bool(),
                 torch.ones(B, max_len - L, dtype=torch.bool, device=dev)], 1)

        kind = _tool_kind(first, tid)
        total0 = torch.where(kind >= C.TOOL_GEN,
                             torch.full_like(kind, num_embs_gen),
                             torch.full_like(kind, num_embs))
        countdown = torch.where(kind > 0, total0, torch.zeros_like(kind))
        done = first == eos_id
        if live is not None:
            done = done | ~live.bool()
        out_tokens = torch.zeros(B, max_new_tokens, dtype=torch.int32,
                                 device=dev)
        out_tokens[:, 0] = torch.where(done & (first != eos_id),
                                       torch.zeros_like(first), first)
        out_hidden = torch.zeros(B, max_new_tokens, cfg.llm.hidden_size,
                                 dtype=torch.float32, device=dev)
        out_logprobs = torch.zeros(B, max_new_tokens, dtype=torch.float32,
                                   device=dev)
        out_logprobs[:, 0] = _token_logprob(last, first)

        step = 1
        while step < max_new_tokens and not bool(done.all()):
            pos = torch.full((B, 1), cache.index, dtype=torch.long,
                             device=dev)
            res = core.llm_step(cur_embed, pos, cache, decode_mask)
            logits = res["logits"][:, -1, :]
            sampled = pick(logits)
            forcing = countdown > 0
            next_token, cur_embed, countdown, kind = advance_tool_state(
                core, tid, num_embs, num_embs_gen, sampled, countdown, kind)
            zero_tok = torch.zeros_like(next_token)
            out_tokens[:, step] = torch.where(done, zero_tok, next_token)
            out_logprobs[:, step] = torch.where(
                done, torch.zeros_like(logits[:, 0]),
                _token_logprob(logits, next_token))
            # the hidden state fed this step belongs to out_tokens[step - 1]
            out_hidden[:, step - 1] = res["hidden"][:, 0].float()
            done = done | ((~forcing) & (sampled == eos_id))
            step += 1
        return {"out_tokens": out_tokens, "out_hidden": out_hidden,
                "out_logprobs": out_logprobs, "num_generated": step,
                "cache": cache}

    return generate


def _draft(tokens: np.ndarray, n_tok: int, K: int) -> np.ndarray:
    """Prompt-lookup drafts [K] (JAX `generation.py:395-414`): the
    continuation of the most recent earlier occurrence of the trailing
    3-gram, else of the trailing 2-gram, over the whole token buffer
    (left-pad zeros included); zeros when nothing matches."""
    buf = len(tokens)
    tm3, t0, t1 = tokens[n_tok - 3], tokens[n_tok - 2], tokens[n_tok - 1]
    j = np.arange(buf)
    cand2 = (tokens == t0) & (np.roll(tokens, -1) == t1) & (j + 1 < n_tok - 1)
    cand3 = cand2 & (np.roll(tokens, 1) == tm3) & (j >= 1) & (n_tok >= 3)
    jm3 = int(np.max(np.where(cand3, j, -1)))
    jm2 = int(np.max(np.where(cand2, j, -1)))
    jm = jm3 if jm3 >= 0 else jm2
    if jm < 0:
        return np.zeros(K, np.int64)
    start = min(max(jm + 2, 0), buf - K)
    return tokens[start:start + K].copy()


def _kind(token: int, tid: SpecialTokenIds) -> int:
    """`_tool_kind` of one host token."""
    return int(_tool_kind(torch.tensor([token]), tid)[0])


def build_speculative_generate_fn(core: VisionLLM, tid: SpecialTokenIds, *,
                                  max_new_tokens: int = 256, eos_id: int = 2,
                                  max_len: int = 4096, k_draft: int = 7):
    """Speculative greedy decoding (JAX `generation.py:339-607`): the same
    tokens and hidden states as `build_generate_fn`, usually in fewer
    forwards. Returns `generate(input_ids [1, L], images,
    first_token=None, attn_mask=None, regions=None)` (`regions` into the
    prefill, as in `build_generate_fn`), whose dict adds `num_windows` to
    `build_generate_fn`'s keys.

    Each window is one cached extend forward (`VisionLLM.llm_window`) of
    W = k_draft + 1 inputs: the last emitted token's embedding, then
    either forced [EMB] table rows (while the countdown is live) or
    prompt-lookup drafts. Position i + 1 is accepted while position i's
    input was the true one (a forced row, or a draft equal to the argmax
    that is neither a tool token nor EOS); the first m positions are
    kept and the cache index is set back to index + m, so the rejected
    K/V stay in the buffer, masked by `pos <= index + i` until the next
    window overwrites them. Drafting and acceptance are integer logic on
    the host (one read of the window's argmax [W]); the embeddings, the
    hidden states and the cache stay on the device. B = 1 only."""
    cfg = core.cfg
    num_embs, num_embs_gen = cfg.num_embs, cfg.num_embs_gen
    K, hid = k_draft, cfg.llm.hidden_size
    W = K + 1
    out_buf = max_new_tokens + W

    def totals(kind: int) -> int:
        return num_embs_gen if kind >= C.TOOL_GEN else num_embs

    def table(kind: int) -> torch.Tensor:
        return {C.TOOL_DET: core.emb_embeddings_det,
                C.TOOL_POSE: core.emb_embeddings_pose,
                C.TOOL_GEN: core.emb_embeddings_gen,
                C.TOOL_EDIT: core.emb_embeddings_edit}[kind]

    def table_rows(kind: int, offs: np.ndarray) -> torch.Tensor:
        t = table(kind)
        idx = torch.from_numpy(np.clip(offs, 0, t.shape[0] - 1))
        return t[idx.to(t.device)]

    @torch.no_grad()
    def generate(input_ids: torch.Tensor, images: Optional[torch.Tensor],
                 first_token: Optional[int] = None,
                 attn_mask: Optional[torch.Tensor] = None,
                 regions: Optional[torch.Tensor] = None) -> Dict[str, Any]:
        B, L = input_ids.shape
        if B != 1:
            raise ValueError("speculative decoding is single-sequence "
                             "(B=1); use build_generate_fn for batches")
        dev = input_ids.device
        buf = L + max_new_tokens + W + 2
        cache = core.new_cache(1, max_len)
        out = core(input_ids, images, tid, attn_mask=attn_mask, cache=cache,
                   regions=regions)
        last = out["logits"][:, -1, :]
        first = torch.argmax(last, dim=-1).to(torch.int32)
        if first_token is not None:
            first = torch.as_tensor(first_token, dtype=torch.int32,
                                    device=dev).reshape(1).clone()
        cur_embed = core.embed_tokens(first[:, None].long())
        out_hidden = torch.zeros(1, out_buf, hid, dtype=torch.float32,
                                 device=dev)
        out_logprobs = torch.zeros(1, out_buf, dtype=torch.float32,
                                   device=dev)
        out_logprobs[:, 0] = _token_logprob(last, first)
        decode_mask = None
        if attn_mask is not None:
            decode_mask = torch.cat(
                [attn_mask.bool(),
                 torch.ones(1, max_len - L, dtype=torch.bool, device=dev)], 1)

        t_first = int(first[0])
        tokens = np.zeros(buf, np.int64)
        tokens[:L] = input_ids[0].cpu().numpy()
        tokens[L] = t_first
        n_tok, step, n_windows = L + 1, 1, 0
        kind = _kind(t_first, tid)
        c = totals(kind) if kind > 0 else 0
        done = t_first == eos_id
        iarr = np.arange(W)
        while step < max_new_tokens and not done:
            idx = cache.index
            total = totals(kind)
            drafts = _draft(tokens, n_tok, K)
            # window position i emits t_i; positions i < c are forced
            forcing = iarr < c
            offs = np.clip(total - c + iarr, 0, None)
            forced_tok = (np.full(W, tid.emb) if kind >= C.TOOL_GEN
                          else tid.emb + offs)
            pred_in = core.embed_tokens(
                torch.from_numpy(drafts).to(dev)[None])[0]       # [K, C]
            if c > 0:
                rows = table_rows(kind, offs[:K]).to(pred_in.dtype)
                pred_in = torch.where(
                    torch.from_numpy(forcing[:K]).to(dev)[:, None], rows,
                    pred_in)
            window = torch.cat([cur_embed, pred_in[None].to(cur_embed.dtype)],
                               dim=1)                            # [1, W, C]
            pos = (idx + torch.arange(W, device=dev))[None]
            res = core.llm_window(window, pos, cache, decode_mask)
            logits = res["logits"][0]                            # [W, V]
            s = torch.argmax(logits, dim=-1).cpu().numpy()       # one read
            s_kind = np.array([_kind(int(x), tid) for x in s[:K]])

            # greedy acceptance
            t = np.where(forcing, forced_tok, s)
            cont = forcing[:K] | ((drafts == s[:K]) & (s_kind == 0)
                                  & (s[:K] != eos_id))
            m = 1 + int(np.cumprod(cont).sum())                  # 1..W
            last_i = m - 1
            t_last = int(t[last_i])
            last_forced = last_i < c
            kind_s = _kind(t_last, tid)
            started = not last_forced and kind_s > 0
            # the next window's slot-0 input: what the step-by-step loop
            # feeds after emitting t_last
            if last_forced:
                cur_embed = table_rows(kind, offs[last_i:last_i + 1])
            elif started:
                cur_embed = table_rows(kind_s, np.zeros(1, np.int64))
            else:
                cur_embed = core.embed_tokens(
                    torch.tensor([[t_last]], device=dev))[0]
            cur_embed = cur_embed[None].to(window.dtype)         # [1, 1, C]
            if last_forced:
                c -= m
            else:
                c, kind = (totals(kind_s), kind_s) if started else (0, 0)

            # keep the first m positions: tokens, logprobs (logits[i]
            # scored the token at out position step + i) and hidden states
            # (hidden[i] belongs to out position step - 1 + i)
            tokens[n_tok:n_tok + m] = t[:m]
            t_dev = torch.from_numpy(t[:m]).to(dev)
            out_logprobs[0, step:step + m] = _token_logprob(logits[:m], t_dev)
            out_hidden[0, step - 1:step - 1 + m] = res["hidden"][0, :m].float()
            cache.index = idx + m
            n_tok += m
            step += m
            n_windows += 1
            done = t_last == eos_id

        # tokens past max_new_tokens (window overshoot) are dropped
        n = min(step, max_new_tokens)
        out_tokens = torch.zeros(1, max_new_tokens, dtype=torch.int32,
                                 device=dev)
        out_tokens[0, :n] = torch.from_numpy(tokens[L:L + n]).to(dev)
        out_logprobs[:, n:] = 0.0
        return {"out_tokens": out_tokens,
                "out_hidden": out_hidden[:, :max_new_tokens],
                "out_logprobs": out_logprobs[:, :max_new_tokens],
                "num_generated": n,
                # acceptance accounting for the serving auto-disable
                "num_windows": n_windows,
                "cache": cache}

    return generate


def extract_tool_queries_from_generation(cfg: VisionLLMConfig,
                                         tid: SpecialTokenIds,
                                         out_tokens: torch.Tensor,
                                         out_hidden: torch.Tensor
                                         ) -> Dict[str, Any]:
    """Post-decode: gather each tool's text queries [B, max_patches, n, C]
    and masks [B, max_patches] from the recorded hidden states."""
    is_emb = (out_tokens >= tid.emb) & (out_tokens < tid.emb + cfg.num_embs)
    ctx, _ = tool_context(out_tokens, tid)
    B = out_tokens.shape[0]
    result = {}
    for name, code, n in (("det", C.TOOL_DET, cfg.num_embs),
                          ("pose", C.TOOL_POSE, cfg.num_embs),
                          ("gen", C.TOOL_GEN, cfg.num_embs_gen),
                          ("edit", C.TOOL_EDIT, cfg.num_embs_gen)):
        rows, valid = compact_masked_rows(out_hidden, is_emb & (ctx == code),
                                          cfg.max_num_patches * n)
        tq = rows.reshape(B, cfg.max_num_patches, n, -1)
        tq_mask = valid.reshape(B, cfg.max_num_patches, n)[..., 0]
        result[name] = (tq, tq_mask)
    return result
