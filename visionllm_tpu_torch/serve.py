"""Chat serving: `ChatService` with request micro-batching or continuous
batching, and a minimal HTTP front for chat and perception (counterpart
of `visionllm_tpu/serve.py`).

* `ChatService` owns a built `VisionLLM` core and a tokenizer. Prompts
  are LEFT-padded to `max_prompt` under an attention mask (exact: RoPE is
  relative and pads are excluded from attention in prefill and decode).
* Micro-batching (the default): a dispatcher thread coalesces concurrent
  requests into one [max_batch] call of the generate loop of
  `generation.py` within `batch_window_ms`, with [max_batch, 1, S, S, 3]
  images; dummy rows are dead (`live=False`). Batched answers equal
  single ones. `sampling=True` adds temperature / top-p requests, one
  generator per call seeded by the first request's `seed` (or a counter).
* Speculative decoding (`spec_k=k`, latency mode, B = 1): each request
  runs `generation.build_speculative_generate_fn` (verify windows of
  k + 1 tokens, prompt-lookup drafts). The service measures the drafter's
  tokens per window; after `SPEC_MIN_WINDOWS` windows below
  `SPEC_BREAK_EVEN` it says so on stderr and switches to the plain greedy
  loop, as the JAX service does. A text-only request runs no vision
  encoder (at B = 1 its zero image would scatter nowhere).
* Continuous batching (`slots=N`, `slots.py`): one scheduler thread owns
  the slot state. Each tick it admits waiting requests into free slots
  (a B1 prefill, or with `prefill_chunk` windows of the cached extend
  forward between which the live slots keep decoding), runs one batched
  decode step (`decode_span` steps with one host read) for every live
  slot, and hands each request its tokens; a request's tokens do not
  depend on its neighbours. `sessions=M` parks a finished session turn's
  KV, and the next turn of that session runs only its new tokens
  (`session_chunk`-wide windows). `generate_stream` yields text deltas.
* Region prompts (a config with `use_region_encoder`): `regions=[...]`,
  each an xyxy box [4] or a binary mask [H, W] in the original image's
  geometry, fill the conversation's one `<regions>` placeholder with
  '<reg>region1<region></reg>, ...'. The masks go to the CLIP geometry,
  padded with empty ones to [max_regions, S, S], and condition the
  prefill through the region encoder (B1 dispatch, speculative, slots
  with B1 or chunked admissions). Micro-batching with `max_batch > 1`
  refuses them, and a session turn reuses its parked KV only with the
  same region masks.

Endpoints (`make_server`)
  GET  /healthz      -> {"ok": true, "model": ..., "devices": [...]}
  GET  /metrics      -> serving counters
  POST /v1/generate  -> {"text", "num_tokens", "ids", "latency_s"
                        [, "logprobs"][, "session", "session_reused"]}
      body: {"prompt": str, "image_b64": str | null (raw RGB uint8),
             "image_shape": [H, W, 3], "max_new_tokens": int | null,
             "history": [...] | null, "temperature"?, "top_p"?, "seed"?,
             "logprobs"?, "session"?, "stream"?, "region_boxes"?,
             "region_masks"?}
      With "stream": true (slot servers) the answer is server-sent
      events: `data: {"delta": ...}` frames, an error frame on a failure
      after the headers, then `data: [DONE]`. A mode the server lacks
      answers 400 with the JAX server's message.
  POST /v1/detect    -> Predictor.detect: {"scores", "labels", "boxes",
                        "class_names"[, "masks": [RLE, ...]]}
      body: {"image_b64", "image_shape", "classes": [str, ...],
             "threshold"?, "topk"?, "with_mask"?}
  POST /v1/ground    -> Predictor.ground: {"box", "score"[, "mask": RLE]}
      body: {"image_b64", "image_shape", "expression": str, "with_mask"?}
  POST /v1/pose      -> Predictor.pose: {"scores", "boxes", "keypoints",
                        "keypoint_names"}
      body: {"image_b64", "image_shape", "keypoint_names"?, "threshold"?,
             "topk"?}

The perception endpoints need `make_server(..., predictor=Predictor)`
(400 without one). One lock serialises the predictor's calls, and at
most 32 perception requests wait or run at once: the next is shed with a
503, as /v1/generate sheds when its queue is full. Floats are rounded to
5 decimals; masks are COCO-compressed RLE (`ops/rle.py`).

The constructor refuses mode conflicts, and chunked prefill or sessions
on an int8 KV cache, with the JAX service's ValueErrors, and an
`image_size` other than the config's (JAX counts (image_size // 14) ** 2
image tokens whatever the encoder yields; the port counts
`cfg.image_token_len`). `close()` stops the service: a later `generate`
raises RuntimeError, and no queued, backlogged, decoding or streaming
request is left waiting (the JAX slot loop leaves them, `serve.py:706`).
A parked session's fill index is the host's count, so a follow-up turn
lands right after its cached prefix even after a length stop inside a
decode span (the JAX scheduler overshoots there, `serve.py:642`).
"""

from __future__ import annotations

import base64
import hashlib
import json
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from visionllm_tpu_torch.constants import DEFAULT_TOKENS
from visionllm_tpu_torch.data.conversation import get_conv_template
from visionllm_tpu_torch.data.mm_utils import (boxes_to_masks,
                                               clip_preprocess,
                                               clip_region_masks,
                                               expand_image_tokens,
                                               find_stop, region_str,
                                               tokenizer_image_token)
from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.generation import (build_generate_fn,
                                            build_speculative_generate_fn)
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds, VisionLLM
from visionllm_tpu_torch.ops.rle import rle_decode, rle_encode
from visionllm_tpu_torch.slots import (build_chunked_prefill_fns,
                                       build_session_fns, build_slot_fns)


class Overloaded(RuntimeError):
    """Request queue is full; callers should retry later (HTTP 503)."""


def _image_key(image: Optional[np.ndarray]) -> Optional[str]:
    """Fingerprint of the preprocessed pixels: session reuse must fall
    back when the same conversation arrives with a swapped image."""
    if image is None:
        return None
    return hashlib.sha1(np.ascontiguousarray(image).tobytes()).hexdigest()


class _Request:
    __slots__ = ("ids", "image", "event", "tokens", "logprobs", "error",
                 "stream_q", "temperature", "top_p", "seed", "session",
                 "session_hit", "regions")

    def __init__(self, ids: np.ndarray, image: Optional[np.ndarray],
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: Optional[int] = None, session: Optional[str] = None,
                 regions: Optional[np.ndarray] = None):
        self.ids = ids
        self.image = image           # preprocessed [S, S, 3] or None
        self.regions = regions       # [max_regions, S, S] masks or None
        self.event = threading.Event()
        self.tokens: Optional[np.ndarray] = None
        self.logprobs: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None
        # streaming (slots mode): per-token queue, None = finished
        self.stream_q: Optional[queue.Queue] = None
        self.temperature = temperature
        self.top_p = top_p
        self.seed = seed
        self.session = session       # session id for KV reuse (slots)
        self.session_hit = False     # set by the scheduler on reuse

    def fail(self, err: BaseException) -> None:
        self.error = err
        if self.stream_q is not None:
            self.stream_q.put(None)
        self.event.set()


def _closed_error() -> RuntimeError:
    return RuntimeError("ChatService is closed")


class ChatService:
    """One built core + tokenizer; thread-safe generation with request
    micro-batching or continuous-batching slots (see the module
    docstring). The core must live on `device` (CUDA unless given; raises
    when there is none). `image_size` defaults to the config's and must
    equal it; `max_regions` bounds the regions of a request."""

    def __init__(self, cfg, core: VisionLLM, tokenizer, *,
                 image_size: Optional[int] = None,
                 conv_version: str = "vicuna_v1",
                 max_new_tokens: int = 256, max_prompt: int = 1024,
                 max_batch: int = 1, batch_window_ms: float = 4.0,
                 spec_k: int = 0, slots: int = 0, prefill_chunk: int = 0,
                 decode_span: int = 1, sampling: bool = False,
                 max_queue: int = 256, sessions: int = 0,
                 session_chunk: int = 64, max_ctx: Optional[int] = None,
                 max_regions: int = 8,
                 device: Optional[Union[str, torch.device]] = None):
        # the JAX service's mode checks, in its order and words
        if spec_k > 0 and max_batch > 1:
            raise ValueError(
                "spec_k (latency mode) and max_batch>1 (throughput mode) "
                "are mutually exclusive: speculative acceptance advances "
                "each stream a different number of tokens per step")
        if slots > 0 and (max_batch > 1 or spec_k > 0):
            raise ValueError(
                "slots (continuous batching) replaces max_batch/spec_k "
                "— pick one serving mode")
        if sampling and spec_k > 0:
            raise ValueError(
                "sampling and speculative decoding are mutually "
                "exclusive: greedy acceptance is what makes the "
                "speculative output exact")
        if sampling and prefill_chunk > 0:
            raise ValueError(
                "sampling with chunked prefill is not wired yet: the "
                "chunked finish samples the first token greedily")
        if prefill_chunk > 0 and cfg.llm.kv_quant == "int8":
            raise ValueError(
                "chunked prefill with an int8 KV cache is not exact: "
                "monolithic prefill attends the fresh bf16 window while "
                "chunk windows read back the quantized cache — run "
                "--prefill-chunk without --kv-quant")
        if sessions > 0 and slots <= 0:
            raise ValueError(
                "session KV reuse rides the continuous-batching slot "
                "state — pass slots > 0 (serve --slots N --sessions M)")
        if sessions > 0 and sampling:
            raise ValueError(
                "session reuse with sampling is not wired yet: the "
                "extension finish samples the first token greedily "
                "(same limitation as chunked prefill)")
        if sessions > 0 and cfg.llm.kv_quant == "int8":
            raise ValueError(
                "session reuse with an int8 KV cache is not exact: the "
                "extend window reads the cache back — run --sessions "
                "without --kv-quant")
        if image_size is None:
            image_size = cfg.vis_encoder.image_size
        if image_size != cfg.vis_encoder.image_size:
            raise ValueError(
                f"image_size {image_size} is not the vision encoder's "
                f"{cfg.vis_encoder.image_size}: the prompt's image tokens "
                "must match its features")
        self.device = resolve_device(device)
        dev_of_core = next(core.parameters()).device
        if dev_of_core.type != self.device.type:
            raise ValueError(f"the core lives on {dev_of_core}, the "
                             f"service on {self.device}")
        self.cfg = cfg
        self.core = core
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.max_regions = max_regions
        self.conv_version = conv_version
        self.max_prompt = max_prompt
        self.max_new_tokens = max_new_tokens
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        self.slots = slots
        self.spec_k = spec_k
        self.sampling = sampling
        self.img_len = cfg.image_token_len
        self.tid = SpecialTokenIds.from_tokenizer(tokenizer)
        eos = getattr(tokenizer, "eos_token_id", None)
        self.eos_id = 2 if eos is None else int(eos)
        self.max_sessions = sessions
        self._seed_counter = 0
        if slots > 0:
            self.prefill_chunk = prefill_chunk
            if prefill_chunk > 0:
                # every chunk full-width: prompts left-pad to a multiple
                self.max_prompt = -(-max_prompt // prefill_chunk) \
                    * prefill_chunk
            slot_max_len = self.max_prompt + max_new_tokens + 8
            if sessions > 0:
                # parked conversations grow turn by turn: follow-up room
                slot_max_len += 3 * (max_new_tokens + 2 * session_chunk)
            if max_ctx is not None:
                slot_max_len = max(slot_max_len, max_ctx)
            self.slot_max_len = slot_max_len
            (self._slot_init, self._slot_prefill, self._slot_insert,
             self._slot_step) = build_slot_fns(
                core, self.tid, n_slots=slots, max_len=slot_max_len,
                eos_id=self.eos_id, sampling=sampling,
                span=max(1, decode_span))
            if prefill_chunk > 0:
                (self._chunk_row, self._chunk_embed, self._chunk_run,
                 self._chunk_finish) = build_chunked_prefill_fns(
                    core, self.tid, chunk=prefill_chunk,
                    max_len=slot_max_len)
            self.session_chunk = session_chunk
            # sid -> {"slot", "ids" (the cached token prefix whose K/V
            # are in the slot), "img", "fill" (row fill index), "stamp"}
            self._sessions: Dict[str, dict] = {}
            self._slot_sid: Dict[int, str] = {}
            self._stamp = 0
            if sessions > 0:
                (self._sess_extract, self._sess_embed, self._sess_extend,
                 self._sess_finish, self._sess_kill) = build_session_fns(core)
            loop = self._slot_loop
        elif spec_k > 0:
            self.generate_fn = build_speculative_generate_fn(
                core, self.tid, max_new_tokens=max_new_tokens,
                eos_id=self.eos_id, max_len=max_prompt + max_new_tokens + 8,
                k_draft=spec_k)
            loop = self._dispatch_loop
        else:
            self.generate_fn = build_generate_fn(
                core, self.tid, max_new_tokens=max_new_tokens,
                eos_id=self.eos_id, max_len=max_prompt + max_new_tokens + 8,
                sampling=sampling)
            loop = self._dispatch_loop
        # the drafter's acceptance (speculative mode): windows and the
        # tokens they emitted, for the auto-disable
        self._spec_tokens = 0
        self._spec_windows = 0
        self._spec_disabled = False
        # serving counters (GET /metrics): ints/floats mutated under the
        # GIL from the dispatcher and request threads. The JAX service's
        # keys; in micro-batching mode also `batches_total` and
        # `steps_total` (generate calls and their num_generated), which
        # let a caller relate kernel launch counts to the work done
        self.stats = {"requests_total": 0, "tokens_generated_total": 0,
                      "latency_sum_s": 0.0, "errors_total": 0,
                      "scheduler_ticks": 0, "occupied_slot_ticks": 0,
                      "batches_total": 0, "steps_total": 0}
        if self.max_sessions > 0:
            self.stats["session_hits"] = 0
            self.stats["session_misses"] = 0
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=max_queue)
        # `closed` and every put of a request change under this lock, so
        # no request is queued behind the close() sentinel
        self._lock = threading.Lock()
        self._closed = False
        self._dispatcher = threading.Thread(target=loop, daemon=True)
        self._dispatcher.start()

    def close(self):
        """Stop the dispatcher thread and drop the core reference. Every
        request still queued, backlogged, decoding or streaming is failed
        with RuntimeError, and later `generate` calls raise it."""
        with self._lock:
            self._closed = True
        self._queue.put(None)
        self._dispatcher.join(timeout=30)
        self.core = self.generate_fn = None

    # spec auto-disable thresholds (the JAX service's): below
    # SPEC_BREAK_EVEN tokens a window over SPEC_MIN_WINDOWS windows, the
    # service switches to the plain greedy loop
    SPEC_MIN_WINDOWS = 64
    SPEC_BREAK_EVEN = 1.15

    def _track_spec_acceptance(self, n_gen: int, n_windows: int) -> None:
        """Count a speculative call's tokens (the first comes from the
        prefill, free) and windows; once enough windows ran below break
        even, switch to `build_generate_fn` (greedy, as spec is)."""
        self._spec_tokens += max(n_gen - 1, 0)
        self._spec_windows += max(n_windows, 0)
        if (self._spec_disabled
                or self._spec_windows < self.SPEC_MIN_WINDOWS):
            return
        accept = self._spec_tokens / self._spec_windows
        if accept >= self.SPEC_BREAK_EVEN:
            return
        print(f"[serve] speculative decoding disabled: measured "
              f"{accept:.2f} tokens/window over {self._spec_windows} "
              f"windows (< break-even {self.SPEC_BREAK_EVEN}); "
              "switching to the plain decode loop", file=sys.stderr,
              flush=True)
        self.generate_fn = build_generate_fn(
            self.core, self.tid, max_new_tokens=self.max_new_tokens,
            eos_id=self.eos_id,
            max_len=self.max_prompt + self.max_new_tokens + 8)
        self._spec_disabled = True
        self.spec_k = 0

    def _submit(self, req: _Request) -> None:
        with self._lock:
            if self._closed:
                raise _closed_error()
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                self.stats["errors_total"] += 1
                raise Overloaded(
                    f"request queue full ({self._queue.maxsize} waiting)"
                ) from None

    def metrics(self) -> dict:
        s = dict(self.stats)
        n = max(s["requests_total"], 1)
        s["latency_avg_s"] = round(s.pop("latency_sum_s") / n, 4)
        if self.slots > 0:
            t = max(s["scheduler_ticks"], 1)
            s["slot_occupancy"] = round(
                s["occupied_slot_ticks"] / (t * self.slots), 4)
            s.pop("batches_total")
            s.pop("steps_total")
        else:
            s.pop("scheduler_ticks")
            s.pop("occupied_slot_ticks")
        s["mode"] = ("slots" if self.slots > 0 else
                     "speculative" if self.spec_k > 0 else
                     f"batch{self.max_batch}")
        if self.spec_k > 0 or self._spec_disabled:
            s["spec_tokens_per_window"] = round(
                self._spec_tokens / max(self._spec_windows, 1), 3)
            s["spec_windows_total"] = self._spec_windows
            s["spec_disabled"] = self._spec_disabled
        return s

    # ---- request assembly (caller thread) ----

    def _encode(self, prompt: str, image: Optional[np.ndarray],
                history: Optional[List] = None, num_regions: int = 0):
        """`history`: prior turns as [user, assistant, ...] strings or
        [{"role", "content"}, ...], rendered through the conversation
        template ahead of the new prompt; <image> attaches to the first
        user turn. With `num_regions` the conversation's one <regions>
        placeholder (a history turn may hold it: clients echo their first
        prompt back) becomes `region_str(num_regions)`. Returns (ids
        int32 [<= max_prompt], pixels or None, conversation)."""
        conv = get_conv_template(self.conv_version)
        turns: List[str] = []
        for i, h in enumerate(history or []):
            if isinstance(h, dict):
                want = ("user", "assistant")[i % 2]
                if h.get("role", want) != want:
                    raise ValueError(
                        f"history must alternate user/assistant starting "
                        f"with user; turn {i} is {h.get('role')!r}")
                turns.append(h["content"])
            else:
                turns.append(h)
        if len(turns) % 2:
            raise ValueError("history must end with an assistant turn")
        turns.append(prompt)
        if num_regions:
            if sum(t.count("<regions>") for t in turns) != 1:
                raise ValueError(
                    "region-prompted requests must place exactly one "
                    "<regions> placeholder in the conversation (e.g. "
                    "'What is <regions>?'); it expands to the region "
                    "token structure for all passed regions")
            i = next(i for i, t in enumerate(turns) if "<regions>" in t)
            turns[i] = turns[i].replace("<regions>",
                                        region_str(num_regions), 1)
        if image is not None:
            turns[0] = "<image>\n" + turns[0]
        for i, text in enumerate(turns):
            conv.append_message(conv.roles[i % 2], text)
        conv.append_message(conv.roles[1], None)
        ids = tokenizer_image_token(conv.get_prompt(), self.tokenizer)
        img = None
        if image is not None:
            imp_id = self.tokenizer.convert_tokens_to_ids(
                DEFAULT_TOKENS["imp"])
            ids = expand_image_tokens(ids, self.img_len, imp_id)
            img = clip_preprocess(image, self.image_size, "pad")
        return np.asarray(ids, np.int32)[-self.max_prompt:], img, conv

    def _check_regions(self, regions: Optional[List],
                       image: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """The JAX service's region checks, in its order and words; the
        padded masks (`_region_masks`), or None without regions."""
        if regions is None:
            return None
        if not self.cfg.use_region_encoder:
            raise ValueError("this model config has no RegionEncoder "
                             "(use_region_encoder=False)")
        if image is None:
            raise ValueError("region prompts need the image they "
                             "refer to (pass image/image_b64)")
        if self.max_batch > 1:
            raise ValueError(
                "region prompts are not supported with request "
                "micro-batching — serve with --max-batch 1 or --slots")
        return self._region_masks(regions, image)

    def _region_masks(self, regions: List, image: np.ndarray) -> np.ndarray:
        """Regions, each an xyxy box [4] or a binary mask [H, W] in the
        original image's geometry -> [max_regions, S, S] masks in the CLIP
        input's geometry, the slots past the request's regions empty
        (the device compacts them away)."""
        h, w = image.shape[:2]
        masks = []
        for r in regions:
            r = np.asarray(r, np.float32)
            if r.ndim == 1 and r.shape[0] == 4:
                masks.append(boxes_to_masks(r[None], h, w)[0])
            elif r.ndim == 2 and r.shape == (h, w):
                masks.append((r > 0).astype(np.float32))
            else:
                raise ValueError(
                    f"each region must be an xyxy box [4] or a mask "
                    f"matching the image [{h}, {w}]; got {r.shape}")
        if not 0 < len(masks) <= self.max_regions:
            raise ValueError(
                f"1..{self.max_regions} regions supported per request "
                f"(max_regions), got {len(masks)}")
        out = np.zeros((self.max_regions, self.image_size,
                        self.image_size), np.float32)
        out[:len(masks)] = clip_region_masks(np.stack(masks),
                                              self.image_size)
        return out

    def _check_request(self, temperature: float, session: Optional[str],
                       regions: Optional[List], image: Optional[np.ndarray],
                       sampling_hint: str) -> Optional[np.ndarray]:
        """The JAX service's request checks, in its order; returns the
        padded region masks (or None)."""
        if temperature > 0 and not self.sampling:
            raise ValueError("temperature > 0 requires a sampling "
                             f"server ({sampling_hint})")
        if session is not None and self.max_sessions <= 0:
            raise ValueError("session KV reuse requires a session "
                             "server (serve --slots N --sessions M)")
        return self._check_regions(regions, image)

    def generate(self, prompt: str, image: Optional[np.ndarray] = None,
                 max_new_tokens: Optional[int] = None,
                 history: Optional[List] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: Optional[int] = None,
                 logprobs: bool = False,
                 session: Optional[str] = None,
                 regions: Optional[List] = None) -> dict:
        """One answer. Temperature > 0 needs a sampling server, a session
        a session server (the JAX service's ValueErrors); `top_p` and
        `seed` are read only when sampling. `regions` (boxes [4] or masks
        [H, W] on `image`) fill the prompt's <regions> placeholder."""
        regs = self._check_request(
            temperature, session, regions, image,
            "ChatService(sampling=True) / serve --sampling")
        ids, img, conv = self._encode(prompt, image, history,
                                      num_regions=len(regions or ()))
        req = _Request(ids, img, temperature=temperature, top_p=top_p,
                       seed=seed, session=session, regions=regs)
        t0 = time.perf_counter()
        self._submit(req)
        req.event.wait()
        latency = time.perf_counter() - t0
        if req.error is not None:
            raise req.error
        tokens = req.tokens
        if max_new_tokens is not None:
            tokens = tokens[:max_new_tokens]
        text = self.tokenizer.decode(tokens, skip_special_tokens=True)
        cut = find_stop(text, [conv.sep2 or conv.sep])
        if cut is not None:
            text = text[:cut]
        self.stats["requests_total"] += 1
        self.stats["tokens_generated_total"] += int(len(tokens))
        self.stats["latency_sum_s"] += latency
        out = {"text": text.strip(), "num_tokens": int(len(tokens)),
               "ids": [int(t) for t in tokens],
               "latency_s": round(latency, 4)}
        if logprobs:
            out["logprobs"] = [round(float(x), 5)
                               for x in req.logprobs[:len(tokens)]]
        if session is not None:
            out["session"] = session
            out["session_reused"] = bool(req.session_hit)
        return out

    def generate_stream(self, prompt: str,
                        image: Optional[np.ndarray] = None,
                        history: Optional[List] = None,
                        max_new_tokens: Optional[int] = None,
                        temperature: float = 0.0, top_p: float = 1.0,
                        seed: Optional[int] = None,
                        session: Optional[str] = None,
                        regions: Optional[List] = None):
        """Incremental generation (slot servers): returns an iterator of
        text deltas as the scheduler decodes. Validation and the submit
        happen here, before any token, so the HTTP layer can still answer
        400 or 503; the iterator raises only for failures mid-decode. The
        stop-string trim and `max_new_tokens` are the blocking path's,
        so the joined deltas equal the blocking answer."""
        if self.slots <= 0:
            raise ValueError("streaming requires continuous batching "
                             "(slots > 0)")
        regs = self._check_request(temperature, session, regions, image,
                                   "serve --sampling")
        ids, img, conv = self._encode(prompt, image, history,
                                      num_regions=len(regions or ()))
        r = _Request(ids, img, temperature=temperature, top_p=top_p,
                     seed=seed, session=session, regions=regs)
        r.stream_q = queue.Queue()
        stop = conv.sep2 or conv.sep
        limit = min(max_new_tokens or self.max_new_tokens,
                    self.max_new_tokens)
        t0 = time.perf_counter()
        self._submit(r)

        def deltas():
            sent = ""
            toks: List[int] = []
            while True:
                item = r.stream_q.get()
                if item is None:
                    break
                toks.append(item)
                text = self.tokenizer.decode(toks[:limit],
                                             skip_special_tokens=True)
                cut = find_stop(text, [stop])
                if cut is not None:
                    text = text[:cut]
                delta = text[len(sent):]
                if delta:
                    sent = text
                    yield delta
                if cut is not None or len(toks) >= limit:
                    break
            if r.error is not None:
                raise r.error
            self.stats["requests_total"] += 1
            self.stats["tokens_generated_total"] += len(toks)
            self.stats["latency_sum_s"] += time.perf_counter() - t0

        return deltas()

    # ---- session (multi-turn prefix) KV reuse ----

    def _session_delta(self, r: _Request):
        """(slot, delta ids, previous fill) when `r` can extend its parked
        session, else None after evicting the stale entry. Reuse needs the
        new ids to start with the EXACT cached prefix, the same image
        pixels and region masks (the <image> and <regions> placeholders
        expand to the same ids for any pixels and masks), a delta free
        of image, region and [EMB] tokens (those
        need the prompt assembly), and room in the KV buffer for the
        window-padded delta plus a full answer."""
        ent = self._sessions.get(r.session)
        if ent is None:
            return None
        cached, ids = ent["ids"], np.asarray(r.ids, np.int32)
        ok = (len(ids) > len(cached)
              and bool(np.array_equal(ids[:len(cached)], cached))
              and ent["img"] == _image_key(r.image)
              and ent["reg"] == _image_key(r.regions))
        if ok:
            delta = ids[len(cached):]
            guard = {self.tid.img, self.tid.imp, self.tid.reg} | set(
                range(self.tid.emb, self.tid.emb + 8))
            ok = not any(int(t) in guard for t in delta)
        if ok:
            E = self.session_chunk
            padded = -(-len(delta) // E) * E
            ok = (ent["fill"]
                  + max(padded, len(delta) + self.max_new_tokens + 1)
                  <= self.slot_max_len)
        if not ok:
            self._evict_session(r.session)
            return None
        return ent["slot"], delta, ent["fill"]

    def _evict_session(self, sid: str) -> None:
        ent = self._sessions.pop(sid, None)
        if ent is not None:
            self._slot_sid.pop(ent["slot"], None)

    def _evict_lru_session(self) -> Optional[int]:
        """Drop the least recently used parked session; returns its freed
        slot (None when nothing is parked)."""
        if not self._sessions:
            return None
        sid = min(self._sessions, key=lambda s: self._sessions[s]["stamp"])
        slot = self._sessions[sid]["slot"]
        self._evict_session(sid)
        return slot

    def _park(self, r: _Request, slot: int, stream: List[int],
              device_dead: bool, state, fill0: int):
        """Keep a finished session request's slot KV for its next turn.
        The LAST token's K/V is not in the cache (it was sampled, never
        fed), so it belongs to the next turn's delta. The slot's device
        fill index is set to the host's count: after a length stop inside
        a decode span the device ran past it."""
        if r.session is None or self.max_sessions <= 0:
            return state
        if not device_dead:
            # length-stopped: the device would advance it every tick
            state = self._sess_kill(state, slot)
        fill = int(fill0) + len(stream) - 1
        state.cache.index[slot] = fill
        self._evict_session(r.session)
        self._stamp += 1
        self._sessions[r.session] = {
            "slot": slot,
            "ids": np.concatenate([np.asarray(r.ids, np.int32),
                                   np.asarray(stream[:-1], np.int32)]),
            "img": _image_key(r.image), "reg": _image_key(r.regions),
            "fill": fill, "stamp": self._stamp}
        self._slot_sid[slot] = r.session
        while len(self._sessions) > self.max_sessions:
            self._evict_lru_session()
        return state

    def _extend_session(self, slot: int, delta: np.ndarray, state,
                        slot_valid, active):
        """Run a session delta through cached extend windows (decode steps
        for the live slots between windows, as a chunked admission).
        Returns (pre, state), `pre` shaped like a prefill result."""
        E = self.session_chunk
        row, valid_row = self._sess_extract(state, slot_valid, slot)
        d = len(delta)
        dp = np.concatenate([delta, np.zeros(((-d) % E,), np.int32)])
        ids = torch.from_numpy(dp.astype(np.int64)).to(self.device)[None]
        last = None
        for k in range(len(dp) // E):
            emb = self._sess_embed(ids[:, k * E:(k + 1) * E])
            row, last = self._sess_extend(emb, row, valid_row,
                                          min(E, d - k * E))
            if active:
                out = self._slot_step(state, slot_valid)
                state = self._dispatch_tokens(out, active, out["state"])
        first, embed, lp = self._sess_finish(last)
        pre = {"first": first[0], "embed": embed, "logprob": lp,
               "cache": row, "valid": valid_row}
        return pre, state

    # ---- continuous-batching scheduler (slots.py engine) ----

    def _slot_loop(self):
        """The scheduler thread owns the device state. Each tick: admit
        waiting requests into free slots, run one decode step (or span)
        for every live slot, hand finished requests their tokens."""
        state, slot_valid = self._slot_init()
        active = {}        # slot -> (request, tokens, logprobs, fill0)
        backlog: List[_Request] = []
        closing = False
        while not closing:
            if not active and not backlog:     # block only when idle
                nxt = self._queue.get()
                if nxt is None:                 # close() sentinel
                    break
                backlog.append(nxt)
            while True:
                try:
                    nxt = self._queue.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    closing = True
                    break
                backlog.append(nxt)
            if closing:
                break
            try:
                while backlog and len(active) < self.slots:
                    # popped only once admitted: a request whose admission
                    # raises is still in the backlog the handler fails
                    # (the JAX loop pops it first and leaves it waiting)
                    state, slot_valid, admitted = self._admit(
                        backlog[0], state, slot_valid, active)
                    if not admitted:
                        break
                    backlog.pop(0)
                if active:
                    self.stats["scheduler_ticks"] += 1
                    self.stats["occupied_slot_ticks"] += len(active)
                    out = self._slot_step(state, slot_valid)
                    state = self._dispatch_tokens(out, active, out["state"])
            except Exception as e:      # noqa: BLE001 - the loop lives on
                self.stats["errors_total"] += len(active) + len(backlog)
                for r in [a[0] for a in active.values()] + backlog:
                    r.fail(e)
                active.clear()
                backlog.clear()
                # parked KV lives in the state that is reset here
                self._sessions.clear()
                self._slot_sid.clear()
                state, slot_valid = self._slot_init()
        # closed: nothing may be left waiting
        for r in [a[0] for a in active.values()] + backlog:
            r.fail(_closed_error())
        self._fail_queued()

    def _admit(self, r: _Request, state, slot_valid, active):
        """Admit `r` into a slot: a session extension, or a prefill
        (chunked or monolithic) into a free slot, evicting the least
        recently used parked session when none is free. Returns (state,
        slot_valid, admitted); not admitted when no slot can be freed."""
        ext = (self._session_delta(r)
               if r.session is not None and self.max_sessions > 0 else None)
        if ext is not None:
            slot, delta, fill_prev = ext
            self._evict_session(r.session)
            self.stats["session_hits"] += 1
            r.session_hit = True
            pre, state = self._extend_session(slot, delta, state,
                                              slot_valid, active)
            state, slot_valid = self._slot_insert(
                state, slot, pre["first"], pre["embed"], pre["cache"],
                pre["valid"], slot_valid)
            state = self._finish_admission(r, slot, pre, active, state,
                                           fill_prev + len(delta))
            return state, slot_valid, True
        if r.session is not None and self.max_sessions > 0:
            self.stats["session_misses"] += 1
        free = [s for s in range(self.slots)
                if s not in active and s not in self._slot_sid]
        if not free:
            freed = self._evict_lru_session()
            if freed is None:
                return state, slot_valid, False
            free = [freed]
        slot = free[0]
        L, dev = self.max_prompt, self.device
        ids, img, mask, _ = self._pack([r])     # max_batch is 1 here
        regs = self._regions_arg([r])
        sample_kw = {}
        if self.sampling:
            self._seed_counter += 1
            seed = r.seed if r.seed is not None else self._seed_counter
            sample_kw = dict(
                generator=torch.Generator(dev).manual_seed(int(seed)),
                temperature=r.temperature, top_p=r.top_p)
        if self.prefill_chunk > 0:
            # chunked admission: the live slots decode between windows,
            # so a long prompt stalls them one window, not the prefill
            C = self.prefill_chunk
            emb = self._chunk_embed(ids, img, regions=regs)
            cache_row = self._chunk_row()
            valid = torch.ones(self.slot_max_len, dtype=torch.bool,
                               device=dev)
            valid[:L] = mask[0]
            last = None
            for k in range(L // C):
                cache_row, last = self._chunk_run(
                    emb[:, k * C:(k + 1) * C], cache_row, valid)
                if active:
                    out = self._slot_step(state, slot_valid)
                    state = self._dispatch_tokens(out, active, out["state"])
            first, embed, first_lp = self._chunk_finish(last)
            pre = {"first": first[0], "embed": embed, "logprob": first_lp,
                   "cache": cache_row, "valid": valid}
        else:
            pre = self._slot_prefill(ids, img, mask, regions=regs,
                                     **sample_kw)
        ins_kw = {}
        if self.sampling:
            ins_kw = dict(temperature=float(r.temperature),
                          top_p=float(r.top_p), generator=pre["generator"])
        state, slot_valid = self._slot_insert(
            state, slot, pre["first"], pre["embed"], pre["cache"],
            pre["valid"], slot_valid, **ins_kw)
        state = self._finish_admission(r, slot, pre, active, state, L)
        return state, slot_valid, True

    def _finish_admission(self, r, slot, pre, active, state, fill0):
        """The shared tail of an admission: surface the first token, then
        finish or activate; `fill0` is the row's fill index after the
        prefill or extension (a session parks from it)."""
        first = int(pre["first"])
        first_lp = float(pre["logprob"])
        if r.stream_q is not None:
            r.stream_q.put(first)
        if first == self.eos_id or self.max_new_tokens <= 1:
            r.tokens = np.asarray([first], np.int32)
            r.logprobs = np.asarray([first_lp], np.float32)
            state = self._park(r, slot, [first], first == self.eos_id,
                               state, fill0)
            if r.stream_q is not None:
                r.stream_q.put(None)
            r.event.set()
        else:
            active[slot] = (r, [first], [first_lp], fill0)
        return state

    def _dispatch_tokens(self, out, active, state):
        """Hand each live slot its new tokens (one host read); finish on
        EOS or length. Returns the slot state (session parking updates
        it)."""
        toks = out["token"].cpu().numpy()
        fins = out["finished"].cpu().numpy()
        lps = out["logprob"].cpu().numpy()
        if toks.ndim == 1:                  # span 1: one frame
            toks, fins, lps = toks[None], fins[None], lps[None]
        for t in range(toks.shape[0]):      # frames in decode order
            for slot in list(active):
                r, stream, lstream, fill0 = active[slot]
                tok = int(toks[t, slot])
                stream.append(tok)
                lstream.append(float(lps[t, slot]))
                if r.stream_q is not None:
                    r.stream_q.put(tok)
                if fins[t, slot] or len(stream) >= self.max_new_tokens:
                    r.tokens = np.asarray(stream, np.int32)
                    r.logprobs = np.asarray(lstream, np.float32)
                    del active[slot]
                    state = self._park(r, slot, stream, bool(fins[t, slot]),
                                       state, fill0)
                    if r.stream_q is not None:
                        r.stream_q.put(None)
                    r.event.set()
        return state

    # ---- batching dispatcher (one thread owns the device) ----

    def _dispatch_loop(self):
        while True:
            first = self._queue.get()
            if first is None:               # close() sentinel
                self._fail_queued()
                return
            batch = [first]
            deadline = time.perf_counter() + self.batch_window_s
            while len(batch) < self.max_batch:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:             # close() during traffic:
                    self._queue.put(None)   # re-arm, finish this batch
                    break
                batch.append(nxt)
            try:
                for r, (t, lp) in zip(batch, self._run(batch)):
                    r.tokens, r.logprobs = t, lp
            except Exception as e:          # noqa: BLE001 - the loop lives on
                self.stats["errors_total"] += len(batch)
                for r in batch:
                    r.error = e
            finally:
                for r in batch:
                    r.event.set()

    def _fail_queued(self):
        """After the sentinel: any request still queued gets the closed
        error, so no caller waits on an event nothing would set."""
        while True:
            try:
                r = self._queue.get_nowait()
            except queue.Empty:
                return
            if r is not None:
                r.fail(_closed_error())

    def _pack(self, batch: List[_Request]):
        """The fixed-shape [max_batch] inputs of one generate call:
        left-padded ids and mask, [B, 1, S, S, 3] pixels, live rows."""
        B, S, L = self.max_batch, self.image_size, self.max_prompt
        ids = np.zeros((B, L), np.int64)
        mask = np.zeros((B, L), bool)
        imgs = np.zeros((B, 1, S, S, 3), np.float32)
        live = np.zeros((B,), bool)
        for b, r in enumerate(batch):
            n = len(r.ids)
            ids[b, L - n:] = r.ids
            mask[b, L - n:] = True
            if r.image is not None:
                imgs[b, 0] = r.image
            live[b] = True
        dev = self.device
        return (torch.from_numpy(ids).to(dev), torch.from_numpy(imgs).to(dev),
                torch.from_numpy(mask).to(dev), torch.from_numpy(live).to(dev))

    def _regions_arg(self, batch: List[_Request]
                     ) -> Optional[torch.Tensor]:
        """The [1, max_regions, S, S] region masks of a call whose request
        carries regions (such a call holds one request), else None."""
        for r in batch:
            if r.regions is not None:
                return torch.from_numpy(r.regions[None]).to(self.device)
        return None

    def _sample_kw(self, batch: List[_Request]) -> dict:
        """A sampling server's generate arguments for one call: one
        generator per call (per-request seeds hold at batch size 1),
        seeded by the first request's `seed` or a counter, and per-row
        temperature and top-p (dummy rows greedy)."""
        seed = batch[0].seed
        if seed is None:
            self._seed_counter += 1
            seed = self._seed_counter
        temp = np.zeros((self.max_batch,), np.float32)
        topp = np.ones((self.max_batch,), np.float32)
        for b, r in enumerate(batch):
            temp[b], topp[b] = r.temperature, r.top_p
        dev = self.device
        return dict(generator=torch.Generator(dev).manual_seed(int(seed)),
                    temperature=torch.from_numpy(temp).to(dev),
                    top_p=torch.from_numpy(topp).to(dev))

    def _run(self, batch: List[_Request]):
        """One [max_batch] generate call; returns per request (tokens up
        to and including EOS, their logprobs)."""
        ids, imgs, mask, live = self._pack(batch)
        regs = self._regions_arg(batch)
        if self.spec_k > 0:
            # latency mode: B = 1, speculative windows; a text-only
            # request skips the vision encoder
            out = self.generate_fn(
                ids, None if batch[0].image is None else imgs,
                attn_mask=mask, regions=regs)
        else:
            kw = self._sample_kw(batch) if self.sampling else {}
            out = self.generate_fn(ids, imgs, attn_mask=mask, live=live,
                                   regions=regs, **kw)
        n_gen = int(out["num_generated"])
        if self.spec_k > 0:
            self._track_spec_acceptance(n_gen, int(out["num_windows"]))
        self.stats["batches_total"] += 1
        self.stats["steps_total"] += n_gen
        toks = out["out_tokens"][:, :n_gen].cpu().numpy()
        lps = out["out_logprobs"][:, :n_gen].cpu().numpy()
        results = []
        for b in range(len(batch)):
            row, lp = toks[b], lps[b]
            ends = np.nonzero(row == self.eos_id)[0]
            if ends.size:
                row, lp = row[:ends[0] + 1], lp[:ends[0] + 1]
            results.append((row, lp))
        return results


def perception_json(out: dict) -> dict:
    """A Predictor result as the perception endpoints send it: masks as
    COCO RLE, integer arrays as lists, float arrays rounded to 5
    decimals."""
    res = {}
    for k, v in out.items():
        if k == "masks":
            res[k] = [rle_encode(m) for m in v]
        elif k == "mask":
            res[k] = rle_encode(v)
        elif isinstance(v, np.ndarray):
            res[k] = (v.tolist() if np.issubdtype(v.dtype, np.integer)
                      else np.round(v.astype(np.float64), 5).tolist())
        else:
            res[k] = v
    return res


class _Handler(BaseHTTPRequestHandler):
    service: ChatService = None     # set by make_server
    model_name: str = "visionllm_tpu_torch"
    predictor = None
    predictor_lock: threading.Lock = None
    predictor_sem: threading.BoundedSemaphore = None

    def log_message(self, fmt, *args):   # quiet by default
        pass

    def _reply(self, code: int, obj: dict):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        if self.path == "/healthz":
            self._reply(200, {"ok": True, "model": self.model_name,
                              "devices": [str(self.service.device)]})
        elif self.path == "/metrics":
            self._reply(200, self.service.metrics())
        else:
            self._reply(404, {"error": "not found"})

    @staticmethod
    def _read_image(req: dict, required: bool = False
                    ) -> Optional[np.ndarray]:
        if req.get("image_b64"):
            raw = base64.b64decode(req["image_b64"])
            return np.frombuffer(raw, np.uint8).reshape(
                tuple(req["image_shape"]))
        if required:
            raise KeyError("image_b64")
        return None

    def _perception(self, req: dict) -> dict:
        """POST /v1/{detect,ground,pose} -> the predictor, JSON-safe."""
        if self.predictor is None:
            raise ValueError("the perception endpoints need a perception "
                             "server (make_server(..., predictor=...))")
        img = self._read_image(req, required=True)
        # at most N perception requests wait or run; shed the next
        if not self.predictor_sem.acquire(blocking=False):
            raise Overloaded("perception queue full")
        try:
            return self._perception_locked(req, img)
        finally:
            self.predictor_sem.release()

    def _perception_locked(self, req: dict, img: np.ndarray) -> dict:
        p = self.predictor
        with self.predictor_lock:
            if self.path == "/v1/detect":
                out = p.detect(img, [str(c) for c in req["classes"]],
                               threshold=float(req.get("threshold", 0.3)),
                               topk=int(req.get("topk", 100)),
                               with_mask=bool(req.get("with_mask")))
            elif self.path == "/v1/ground":
                out = p.ground(img, str(req["expression"]),
                               with_mask=bool(req.get("with_mask")))
            else:
                out = p.pose(img, keypoint_names=req.get("keypoint_names"),
                             threshold=float(req.get("threshold", 0.3)),
                             topk=int(req.get("topk", 20)))
        return perception_json(out)

    def do_POST(self):
        if self.path in ("/v1/detect", "/v1/ground", "/v1/pose"):
            handle = self._perception
        elif self.path == "/v1/generate":
            handle = self._generate
        else:
            self._reply(404, {"error": "not found"})
            return
        try:
            n = int(self.headers.get("Content-Length", 0))
            out = handle(json.loads(self.rfile.read(n) or b"{}"))
            if isinstance(out, dict):
                self._reply(200, out)
                return
        except (KeyError, ValueError, TypeError) as e:
            self._reply(400, {"error": f"bad request: {e}"})
            return
        except Overloaded as e:
            self._reply(503, {"error": str(e), "retry": True})
            return
        except Exception as e:                          # noqa: BLE001
            self._reply(500, {"error": str(e)[:500]})
            return
        self._stream(out)

    def _stream(self, deltas):
        """Server-sent events: one data frame per text delta, an error
        frame for a failure after the headers, then [DONE]."""
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()
        try:
            for delta in deltas:
                frame = json.dumps({"delta": delta})
                self.wfile.write(f"data: {frame}\n\n".encode())
                self.wfile.flush()
        except Exception as e:                          # noqa: BLE001
            frame = json.dumps({"error": str(e)[:300]})
            self.wfile.write(f"data: {frame}\n\n".encode())
        self.wfile.write(b"data: [DONE]\n\n")

    def _generate(self, req: dict):
        """POST /v1/generate, reading the fields the JAX server reads:
        the answer's dict, or with "stream" the iterator of text deltas
        (validated and submitted before any header goes out)."""
        prompt = req["prompt"]
        image = self._read_image(req)
        regions = None
        if req.get("region_boxes") or req.get("region_masks"):
            regions = [np.asarray(b, np.float32)
                       for b in req.get("region_boxes") or ()]
            regions += [rle_decode(m["counts"], *m["size"]).astype(
                np.float32) for m in req.get("region_masks") or ()]
        kw = dict(history=req.get("history"),
                  max_new_tokens=req.get("max_new_tokens"),
                  temperature=float(req.get("temperature", 0.0)),
                  top_p=float(req.get("top_p", 1.0)),
                  seed=req.get("seed"), session=req.get("session"),
                  regions=regions)
        if req.get("stream"):
            return self.service.generate_stream(prompt, image, **kw)
        return self.service.generate(prompt, image,
                                     logprobs=bool(req.get("logprobs")),
                                     **kw)


def make_server(service: ChatService, host: str = "127.0.0.1",
                port: int = 8000, model_name: str = "visionllm_tpu_torch",
                predictor=None) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server; with `predictor` (an
    `infer.Predictor`) it also serves the perception endpoints."""
    handler = type("Handler", (_Handler,),
                   {"service": service, "model_name": model_name,
                    "predictor": predictor,
                    "predictor_lock": threading.Lock(),
                    "predictor_sem": threading.BoundedSemaphore(32)})
    return ThreadingHTTPServer((host, port), handler)
