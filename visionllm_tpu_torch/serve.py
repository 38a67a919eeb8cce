"""Chat serving: `ChatService` with request micro-batching, and a minimal
HTTP front for chat and perception (counterpart of
`visionllm_tpu/serve.py` in its dispatch-loop mode, with its perception
endpoints).

* `ChatService` owns a built `VisionLLM` core, a tokenizer and the greedy
  generate loop of `generation.py`. Prompts are LEFT-padded to
  `max_prompt` under an attention mask (exact: RoPE is relative and pads
  are excluded from attention in prefill and decode), and every call has
  the fixed shape [max_batch, max_prompt] with [max_batch, 1, S, S, 3]
  images (the per-sample feature scatter keeps text-only rows aligned).
* Micro-batching: a dispatcher thread coalesces concurrent requests into
  one [max_batch] generate call within `batch_window_ms`; dummy rows are
  dead (`live=False`). Batched answers equal single ones.

Endpoints (`make_server`)
  GET  /healthz      -> {"ok": true, "model": ..., "devices": [...]}
  GET  /metrics      -> serving counters
  POST /v1/generate  -> {"text", "num_tokens", "ids", "latency_s"}
      body: {"prompt": str, "image_b64": str | null (raw RGB uint8),
             "image_shape": [H, W, 3], "max_new_tokens": int | null,
             "history": [...] | null, "temperature"?, "top_p"?, "seed"?,
             "session"?, "stream"?, "region_boxes"?, "region_masks"?}
      The last fields are read as the JAX server reads them; the modes
      this server lacks (sampling, sessions, streaming, region prompts)
      answer 400 with the JAX server's message.
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

Not ported: continuous-batching slots, speculative decoding, sampling
and session KV reuse (the constructor raises NotImplementedError for
each). A request for sampling, a session, a stream or region prompts is
refused with the ValueError the JAX service raises in the same mode.
`close()` stops the service: a later `generate` raises RuntimeError, and
no queued request is left waiting.
"""

from __future__ import annotations

import base64
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Union

import numpy as np
import torch

from visionllm_tpu_torch.constants import DEFAULT_TOKENS
from visionllm_tpu_torch.data.conversation import get_conv_template
from visionllm_tpu_torch.data.mm_utils import (clip_preprocess,
                                               expand_image_tokens,
                                               find_stop,
                                               tokenizer_image_token)
from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.generation import build_generate_fn
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds, VisionLLM
from visionllm_tpu_torch.ops.rle import rle_decode, rle_encode


class Overloaded(RuntimeError):
    """Request queue is full; callers should retry later (HTTP 503)."""


class _Request:
    __slots__ = ("ids", "image", "event", "tokens", "logprobs", "error")

    def __init__(self, ids: np.ndarray, image: Optional[np.ndarray]):
        self.ids = ids
        self.image = image           # preprocessed [S, S, 3] or None
        self.event = threading.Event()
        self.tokens: Optional[np.ndarray] = None
        self.logprobs: Optional[np.ndarray] = None
        self.error: Optional[BaseException] = None


class ChatService:
    """One built core + tokenizer; thread-safe greedy generation with
    request micro-batching. The core must live on `device` (CUDA unless
    given; raises when there is none)."""

    def __init__(self, cfg, core: VisionLLM, tokenizer, *,
                 image_size: int = 336, conv_version: str = "vicuna_v1",
                 max_new_tokens: int = 256, max_prompt: int = 1024,
                 max_batch: int = 1, batch_window_ms: float = 4.0,
                 max_queue: int = 256,
                 device: Optional[Union[str, torch.device]] = None,
                 spec_k: int = 0, slots: int = 0, sampling: bool = False,
                 sessions: int = 0):
        for name, on in (("spec_k", spec_k), ("slots", slots),
                         ("sampling", sampling), ("sessions", sessions)):
            if on:
                raise NotImplementedError(
                    f"ChatService({name}=...) is not ported; the port "
                    "serves greedy micro-batched generation only")
        self.device = resolve_device(device)
        dev_of_core = next(core.parameters()).device
        if dev_of_core.type != self.device.type:
            raise ValueError(f"the core lives on {dev_of_core}, the "
                             f"service on {self.device}")
        self.cfg = cfg
        self.core = core
        self.tokenizer = tokenizer
        self.image_size = image_size
        self.conv_version = conv_version
        self.max_prompt = max_prompt
        self.max_new_tokens = max_new_tokens
        self.max_batch = max_batch
        self.batch_window_s = batch_window_ms / 1e3
        self.img_len = (image_size // 14) ** 2
        self.tid = SpecialTokenIds.from_tokenizer(tokenizer)
        eos = getattr(tokenizer, "eos_token_id", None)
        self.eos_id = 2 if eos is None else int(eos)
        self.generate_fn = build_generate_fn(
            core, self.tid, max_new_tokens=max_new_tokens,
            eos_id=self.eos_id, max_len=max_prompt + max_new_tokens + 8)
        # serving counters (GET /metrics): ints/floats mutated under the
        # GIL from the dispatcher and request threads; `batches_total` and
        # `steps_total` (generate calls and their num_generated) let a
        # caller relate kernel launch counts to the work done
        self.stats = {"requests_total": 0, "tokens_generated_total": 0,
                      "latency_sum_s": 0.0, "errors_total": 0,
                      "batches_total": 0, "steps_total": 0}
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue(
            maxsize=max_queue)
        # `closed` and every put of a request change under this lock, so
        # no request is queued behind the close() sentinel
        self._lock = threading.Lock()
        self._closed = False
        self._dispatcher = threading.Thread(target=self._dispatch_loop,
                                            daemon=True)
        self._dispatcher.start()

    def close(self):
        """Stop the dispatcher thread and drop the core reference. Later
        `generate` calls raise RuntimeError."""
        with self._lock:
            self._closed = True
        self._queue.put(None)
        self._dispatcher.join(timeout=30)
        self.core = self.generate_fn = None

    def _submit(self, req: _Request) -> None:
        with self._lock:
            if self._closed:
                raise RuntimeError("ChatService is closed")
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
        s["mode"] = f"batch{self.max_batch}"
        return s

    # ---- request assembly (caller thread) ----

    def _encode(self, prompt: str, image: Optional[np.ndarray],
                history: Optional[List] = None):
        """`history`: prior turns as [user, assistant, ...] strings or
        [{"role", "content"}, ...], rendered through the conversation
        template ahead of the new prompt; <image> attaches to the first
        user turn. Returns (ids int32 [<= max_prompt], pixels or None,
        conversation)."""
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

    def _check_regions(self, regions: Optional[List]) -> None:
        """The JAX service's first region check: a config without a
        region encoder refuses region prompts."""
        if regions is None:
            return
        if not getattr(self.cfg, "use_region_encoder", False):
            raise ValueError("this model config has no RegionEncoder "
                             "(use_region_encoder=False)")
        raise NotImplementedError("region prompts are not ported")

    def generate(self, prompt: str, image: Optional[np.ndarray] = None,
                 max_new_tokens: Optional[int] = None,
                 history: Optional[List] = None,
                 temperature: float = 0.0, top_p: float = 1.0,
                 seed: Optional[int] = None,
                 logprobs: bool = False,
                 session: Optional[str] = None,
                 regions: Optional[List] = None) -> dict:
        """Greedy generation. `top_p` and `seed` are read only when
        sampling, so at temperature 0 they change nothing, as in JAX.
        Sampling and sessions are refused with the JAX service's words."""
        if temperature > 0:
            raise ValueError("temperature > 0 requires a sampling "
                             "server (ChatService(sampling=True) / "
                             "serve --sampling)")
        if session is not None:
            raise ValueError("session KV reuse requires a session "
                             "server (serve --slots N --sessions M)")
        self._check_regions(regions)
        ids, img, conv = self._encode(prompt, image, history)
        req = _Request(ids, img)
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
        return out

    def generate_stream(self, prompt: str,
                        image: Optional[np.ndarray] = None, *,
                        history: Optional[List] = None,
                        max_new_tokens: Optional[int] = None,
                        temperature: float = 0.0, top_p: float = 1.0,
                        seed: Optional[int] = None,
                        session: Optional[str] = None,
                        regions: Optional[List] = None):
        """Streaming needs continuous-batching slots, which this service
        does not have: raises the JAX service's ValueError for a server
        without slots, before any token (the HTTP layer answers 400)."""
        raise ValueError("streaming requires continuous batching "
                         "(slots > 0)")

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
                r.error = RuntimeError("ChatService is closed")
                r.event.set()

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

    def _run(self, batch: List[_Request]):
        """One [max_batch] generate call; returns per request (tokens up
        to and including EOS, their logprobs)."""
        ids, imgs, mask, live = self._pack(batch)
        out = self.generate_fn(ids, imgs, attn_mask=mask, live=live)
        n_gen = int(out["num_generated"])
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
            self._reply(200, handle(json.loads(self.rfile.read(n) or b"{}")))
        except (KeyError, ValueError, TypeError) as e:
            self._reply(400, {"error": f"bad request: {e}"})
        except Overloaded as e:
            self._reply(503, {"error": str(e), "retry": True})
        except Exception as e:                          # noqa: BLE001
            self._reply(500, {"error": str(e)[:500]})

    def _generate(self, req: dict) -> dict:
        """POST /v1/generate, reading the fields the JAX server reads."""
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
            # refused before any header goes out: a 400
            self.service.generate_stream(prompt, image, **kw)
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
