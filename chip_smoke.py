#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels flash_bwd,msda_bwd   # checks alone

Phases, each printing one JSON line:

1. device  - requires a CUDA card (exits 2 without one) and prints
             `nvidia-smi --query-gpu=name,power.limit` for it;
2. build   - builds every CUDA kernel of the det and chat paths from
             `visionllm_tpu_torch/csrc/` (one nvcc per source, in
             parallel) and reports the seconds;
3. kernel  - holds each kernel against its plain PyTorch version at the
             main-path shapes, on the card, with the tolerance below, and
             times the kernel, the plain version and one PyTorch library
             call computing the same function (yardstick only; the port
             never calls it); a backward kernel is held against autograd
             of the plain forward, output by output. The flash forward
             also runs the chat prefill (B4 L640) and a causal L2048.
             Every case prints `device_ms` (and `library_device_ms` where
             a library call computes the same function): device time per
             call from torch.profiler's kernel events, one profiler
             context per check, beside `ms` (CUDA events around
             back-to-back calls, which for a short kernel include the
             wrapper's host time); the phase fails unless a flash-forward
             or int4 call is one kernel and a flash backward call
             `FLASH_BWD_KERNELS`. The MSDA cases add inputs of the model's
             own sampling, captured from a warm det request and a train
             step (`captured_*`; each capture builds its model), and time
             the grid_sample composition (`composite_*`) where no single
             library call computes MSDA;
4. slice   - the det path: builds `VisionLLMWithTools` at full width
             (CLIP-L/336 24 layers, LLaMA-7B 32 layers, Grounding-DINO
             with Swin-T at 512 px) in bf16 with seeded random weights,
             answers 3 det requests through `infer_det`, checks shapes,
             finiteness and the launch counters (flash 56 and MSDA 12 per
             request), holds the text queries and the top-900 selection
             against the same model run with the plain versions, and
             times a request and its stages;
5. profile - one more det request under torch.profiler: device kernel
             time, the device's idle share, the kernels that take the
             most and each kernel of the port's own (as in phases 7, 9);
6. serve   - the chat path, after the det model is freed: `build_core`
             of the 7B chat config with `quant="int4"` at full width,
             `ChatService(max_batch=4, max_prompt=640, max_new_tokens=32)`
             with the port's `SimpleTokenizer`; 4 image requests from
             threads (one generate call), the first of them again alone, a
             text-only request with a history, and the first again over
             HTTP. Checks the answers, the launch counters (int4 225 per
             forward, flash 56 per generate call), holds the prefill and
             every decode step's logits against a plain run teacher-forced
             on the kernel run's tokens, and times TTFT, a decode step and
             tok/s;
7. serve_profile - one decode step under torch.profiler;
8. train   - the det training step, after the chat model is freed: the
             stage-1 frozen `vllm_7b_det_config()` at full width and
             depth (LLaMA 32 layers, CLIP 24, Grounding-DINO with Swin-T
             at 640 px, CDN with dn_number 100, 12544 mask points) in
             bf16 with fp32 masters, bs 1 as `bench_train.py` builds its
             batch. One step with the kernels against the plain versions
             (same weights, batch, draws and discrete choices): the loss
             terms against the all-plain step, the trainable gradient
             against the step with the plain backwards (see run_train);
             then 5 AdamW steps: finite losses, trainable masters moved,
             frozen parameters bit-identical, and per step flash fwd 56,
             flash bwd 32, MSDA fwd 12, MSDA bwd 12 launches; step ms,
             peak memory, the loss trace;
9. train_profile - one more step under torch.profiler;
10. probes - the gather probes' entry point
             (`visionllm_tpu_torch/tools/msda_kernel_attempts.py`).

Then it prints the `{"kernels": [...]}` line, the card's name and power
limit, and as its last line `{"ok": true, "device": {...}}`. Any failed
check raises, so the script exits nonzero and prints no ok line.
"""

from __future__ import annotations

import argparse
import base64
import functools
import gc
import itertools
import json
import math
import re
import statistics
import subprocess
import sys
import threading
import time
import urllib.request
from contextlib import ExitStack
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from visionllm_tpu_torch import constants as C
from visionllm_tpu_torch.config import (LLMConfig, OptimizerConfig,
                                        vllm_7b_chat_config,
                                        vllm_7b_det_config)
from visionllm_tpu_torch.generation import _tool_kind, advance_tool_state
from visionllm_tpu_torch.kernels import build
from visionllm_tpu_torch.models.composite import build_core, build_model
from visionllm_tpu_torch.models.llama import KVCache
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.ops import attention as A
from visionllm_tpu_torch.ops import gather as G
from visionllm_tpu_torch.ops import ms_deform_attn as M
from visionllm_tpu_torch.ops import quant4 as Q
from visionllm_tpu_torch.serve import ChatService, _Request, make_server
from visionllm_tpu_torch.tools import msda_kernel_attempts as probes
from visionllm_tpu_torch.train.runner import TrainConfig, frozen_predicate
from visionllm_tpu_torch.train.train_step import (TrainState, build_optimizer,
                                                  det_loss, draw_step_noise,
                                                  make_det_train_step)
from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
DET_SIZE = 512
N_REQUESTS = 3
N_TIMED = 5
# kernel vs plain on the card, bf16 outputs: max |kernel - plain| must
# stay within ATOL + RTOL * max |plain| (a few bf16 ulps of the outputs,
# which both round from fp32 sums taken in another order)
ATOL, RTOL = 2e-2, 1e-2
# text queries after 32 bf16 LLaMA layers, kernel run vs plain run:
# relative Frobenius error
TQ_REL_TOL = 5e-2
# chat serving: the batch shape ChatService compiles to, and the logits
# of the kernel run vs the plain run teacher-forced on its tokens
# (relative Frobenius error per step, live rows)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 640, 32
# the 4 threaded requests resize their images on the host before they
# queue; the window lets the slowest still join the first one's call
# (200 ms missed it once on a slow host)
BATCH_WINDOW_MS = 500.0
LOGIT_REL_TOL = 5e-2
L2_BYTES = 50 * 2 ** 20       # H100 L2: decode weights are timed cold
# the det train step (bench_train.py's batch): det image, targets per
# image, AdamW steps on the main path; kernel run vs plain run of one
# step: each loss term and the concatenated trainable gradient, relative
TRAIN_DET = 640
TRAIN_TARGETS = 20
TRAIN_STEPS = 5
TRAIN_REL_TOL = 5e-2
# kernels one `flash_attention_bwd` call launches: Di = rowsum(dO * O),
# then one grid of the dQ and dK/dV blocks
FLASH_BWD_KERNELS = 2


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, n=20, warmup=3):
    """Mean device ms of fn over n back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def device_ms(fns, n=20, warmup=3, gap_s=0.05):
    """Device time per call of each fn of `fns` (label -> fn), from one
    torch.profiler context (the profiler has lost a context's device
    events once a process had opened a dozen): each fn's n back-to-back
    calls, ended by a synchronize, run inside a `record_function` range
    of its label, `gap_s` apart; each CUDA kernel counts for the range
    nearest to its start if it starts within gap_s / 2 of it. The
    device's clock may sit off the host's, by over 1.25 ms in one context
    (64 kernels of a 5 ms gap's ranges fell outside them): with ranges 50
    ms apart any offset under 25 ms still finds each kernel its range. A
    range of one warm-up kernel comes first: the profiler once dropped
    the first kernel of a context.
    Returns per label the summed device ms over n, the kernels counted per
    call and each kernel name's device ms per call, and the number of
    kernels that fell in no range. Unlike `cuda_ms` it leaves out the
    host's time between launches."""
    warm = "device_ms:warm-up"
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(warm):
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
        for label, fn in fns.items():
            time.sleep(gap_s)
            with record_function(label):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
    events = prof.events()
    labels = [warm, *fns]
    windows = {e.name: e.time_range for e in events
               if e.name in labels and e.device_type == DeviceType.CPU}
    us, count, stray = dict.fromkeys(labels, 0.0), dict.fromkeys(labels, 0), 0
    names = {label: {} for label in labels}     # kernel name -> device us
    for e in events:
        if e.device_type != DeviceType.CUDA or e.name in labels:
            continue                        # the ranges' own annotations
        t = e.time_range.start
        dist, label = min((max(w.start - t, t - w.end, 0), label)
                          for label, w in windows.items())
        if dist > gap_s * 1e6 / 2:
            stray += 1
            continue
        us[label] += e.device_time_total
        count[label] += 1
        names[label][e.name] = names[label].get(e.name, 0.0) + \
            e.device_time_total
    return {label: {"ms": us[label] / 1e3 / n,
                    "kernels_per_call": count[label] / n,
                    "ms_by_kernel": {k: t / 1e3 / n for k, t in
                                     sorted(names[label].items())}}
            for label in fns}, stray


def device_ms_update(cases, timed):
    """`device_ms` (and, where `timed` has a ":library" or ":composite"
    label for the case, `library_device_ms` or `composite_device_ms`) of
    every case from one profiler context, with the kernels a call launches
    on each side and their names."""
    dev, stray = device_ms(timed)
    for case in cases:
        kern = dev[case["case"] + ":kernel"]
        case.update(device_ms=kern["ms"],
                    kernels_per_call=kern["kernels_per_call"],
                    kernel_names=[k[:90] for k in kern["ms_by_kernel"]],
                    profiler_stray_kernels=stray)
        if len(kern["ms_by_kernel"]) > 1:
            case["device_ms_by_kernel"] = {
                k[:90]: t for k, t in kern["ms_by_kernel"].items()}
        comp = dev.get(case["case"] + ":composite")
        if comp is not None:
            case.update(composite_device_ms=comp["ms"],
                        composite_kernels_per_call=comp["kernels_per_call"])
        libd = dev.get(case["case"] + ":library")
        if libd is not None:
            case.update(library_device_ms=libd["ms"],
                        library_kernels_per_call=libd["kernels_per_call"],
                        library_kernel_names=[k[:90] for k in
                                              libd["ms_by_kernel"]])


def host_ms(fn, n=N_TIMED):
    """Median wall ms of fn, each call ended by a device sync."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


def bound(nbytes, flops, peak_flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(name, got, want):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    tol = ATOL + RTOL * scale
    if not (err <= tol):
        raise AssertionError(f"{name}: max abs err {err} > {tol}")
    return err


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at main-path shapes
# ---------------------------------------------------------------------------

def attention_cases(g, more=False):
    """The flash cases at main-path shapes; `more` adds the chat prefill
    inside `ChatService` (B4 L640) and a long causal L2048, where the
    tensor-core rate, not the wave count, sets the pace."""
    dev = "cuda"

    def rnd(*s):
        return torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)

    seg = torch.ones(2, 586, dtype=torch.int32, device=dev)
    seg[1, :200] = 0           # a left-padded prompt beside a full one
    # (name, B, L, H, H_kv, D, causal, segment_ids)
    specs = [("clip_l", 1, 577, 16, 16, 64, False, None),
             ("llama7b_prefill", 1, 586, 32, 32, 128, True, None),
             ("gqa_h32_kv8", 1, 586, 32, 8, 128, True, None),
             ("segments", 2, 586, 32, 32, 128, True, seg)]
    if more:
        specs += [("chat_prefill_b4", SERVE_BATCH, SERVE_PROMPT, 32, 32, 128,
                   True, None),
                  ("long_l2048", 1, 2048, 32, 32, 128, True, None)]
    for name, B, L, H, Hkv, D, causal, sg in specs:
        yield name, rnd(B, L, H, D), rnd(B, L, Hkv, D), rnd(B, L, Hkv, D), \
            causal, sg


def attention_pairs(L, causal, seg):
    """Attending (query, key) pairs per batch row that this input needs."""
    if seg is None:
        per = L * (L + 1) // 2 if causal else L * L
        return [per]
    allowed = seg[:, :, None] == seg[:, None, :]
    if causal:
        allowed = allowed & torch.ones(L, L, dtype=torch.bool,
                                       device=seg.device).tril()
    return allowed.sum(dim=(1, 2)).tolist()


def sdpa(qh, kh, vh, causal, mask):
    """`scaled_dot_product_attention` on [B, H, L, D] inputs: the library
    yardstick of the flash forward (never called by the port)."""
    if mask is None:
        return F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=causal,
            enable_gqa=kh.shape[1] != qh.shape[1])
    return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)


def check_attention(g):
    cases, timed = [], {}
    for name, q, k, v, causal, seg in attention_cases(g, more=True):
        B, L, H, D = q.shape
        Hkv = k.shape[2]
        got = A.flash_attention(q, k, v, causal=causal, segment_ids=seg)
        want = A.flash_attention_plain(q, k, v, causal=causal,
                                       segment_ids=seg)
        torch.cuda.synchronize()
        err = check_close(f"flash_attention[{name}]", got, want)
        qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        mask = None
        if seg is not None:
            mask = (seg[:, None, :, None] == seg[:, None, None, :]) & \
                torch.ones(L, L, dtype=torch.bool, device=q.device).tril()

        lib = functools.partial(sdpa, qh, kh, vh, causal, mask)
        lib_out = lib().transpose(1, 2)
        torch.cuda.synchronize()
        check_close(f"sdpa[{name}]", lib_out, want)
        pairs = sum(attention_pairs(L, causal, seg)) * H
        flops = 4 * pairs * D
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel()) + \
            (0 if seg is None else seg.numel() * 4)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        kernel = functools.partial(A.flash_attention, q, k, v, causal=causal,
                                   segment_ids=seg)
        case = {
            "case": name, "shape": [B, L, H, Hkv, D], "causal": causal,
            "segment_ids": seg is not None, "max_abs_err": err,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: A.flash_attention_plain(
                q, k, v, causal=causal, segment_ids=seg)),
            "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":library"] = kernel, lib
        cases.append(case)
    device_ms_update(cases, timed)
    for case in cases:
        # every wrapper call launches one kernel: each must be counted
        if case["kernels_per_call"] != 1:
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call")
        emit({"phase": "kernel", "kernel": "flash_attn_fwd", **case})
    return cases


def msda_inputs(g, Q=None, det=DET_SIZE):
    """Inputs at the det shapes of a `det` px image; Q=None gives the
    encoder's Q = S."""
    shapes = tuple((det // s, det // s) for s in (8, 16, 32, 64))
    S = sum(h * w for h, w in shapes)
    Q = S if Q is None else Q
    value = torch.randn(1, S, 8, 32, generator=g, device="cuda").to(
        torch.bfloat16)
    # locations partly outside [0, 1] to exercise the zero padding
    loc = torch.rand(1, Q, 8, 4, 4, 2, generator=g, device="cuda") * 1.4 - 0.2
    attw = torch.softmax(torch.randn(1, Q, 8, 16, generator=g, device="cuda"),
                         -1).reshape(1, Q, 8, 4, 4)
    return value, shapes, loc, attw


def msda_uniform_cases(g, bwd):
    """(name, value, shapes, loc, attw[, grad_out]) at the main-path
    shapes, locations spread uniformly over (and past) every map: the
    512 px det request's encoder and decoder (forward only) and the 640 px
    train step's."""
    specs = [("train_encoder", None, TRAIN_DET),
             ("train_decoder", 1100, TRAIN_DET)]
    if not bwd:
        specs = [("encoder", None, DET_SIZE),
                 ("decoder", 900, DET_SIZE)] + specs
    for name, Q, det in specs:
        value, shapes, loc, attw = msda_inputs(g, Q, det)
        if bwd:
            gout = torch.randn(1, loc.shape[1], 256, generator=g,
                               device="cuda").to(torch.bfloat16)
            yield name, value, shapes, loc, attw, gout
        else:
            yield name, value, shapes, loc, attw


class MSDARecorder:
    """Wraps an MSDA wrapper (forward or backward) and keeps a copy of the
    arguments of its first encoder call (Q == S) and its first decoder
    call, then calls it. Its `launches` is the wrapped wrapper's, which
    the kernel path counts through the name this object replaces."""

    def __init__(self, fn, prefix):
        self.fn, self.prefix, self.calls = fn, prefix, {}

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, n):
        self.fn.launches = n

    def __call__(self, value, shapes, loc, attw, *rest):
        kind = "encoder" if loc.shape[1] == value.shape[1] else "decoder"
        if self.prefix + kind not in self.calls:
            self.calls[self.prefix + kind] = tuple(
                t.detach().clone() if torch.is_tensor(t) else t
                for t in (value, shapes, loc, attw, *rest))
        return self.fn(value, shapes, loc, attw, *rest)


def captured_msda_fwd():
    """The MSDA inputs of the model's own sampling: the first encoder and
    decoder call of a warm det request (the slice phase's model, seed 0,
    and first request), recorded around `M.ms_deform_attn`."""
    cfg = vllm_7b_det_config()
    tid = SpecialTokenIds.synthetic()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    ids, images, aug = make_requests(
        cfg, tid, torch.Generator(device="cuda").manual_seed(1))[0]
    rec = MSDARecorder(M.ms_deform_attn, "captured_det_")
    with torch.no_grad():
        model.infer_det(ids, images, aug, tid)            # warm
        with mock.patch.object(M, "ms_deform_attn", rec):
            model.infer_det(ids, images, aug, tid)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return [(name, *args) for name, args in sorted(rec.calls.items())]


def captured_msda_bwd():
    """The MSDA backward's inputs in the model's own train step (the train
    phase's model, batch and first step): the first encoder and decoder
    call of the backward, with the grad_out that reaches it, recorded
    around `M.ms_deform_attn_bwd`."""
    cfg, tid, model, state, step = build_train()
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = train_batch(cfg, tid, g)
    rec = MSDARecorder(M.ms_deform_attn_bwd, "captured_train_")
    with mock.patch.object(M, "ms_deform_attn_bwd", rec):
        step(state, batch, generator=g)
    del model, state, step, batch
    gc.collect()
    torch.cuda.empty_cache()
    return [(name, *args) for name, args in sorted(rec.calls.items())]


def msda_composite(value, shapes, loc, attw):
    """MSDA composed of PyTorch calls as Deformable DETR's
    `ms_deform_attn_core_pytorch` does it: one `F.grid_sample(bilinear,
    zeros, align_corners=False)` per level on [B H, D, h, w] maps and an
    attention-weighted sum, in fp32 -> [B, Q, H D] fp32. A yardstick
    only: the port never calls it."""
    B, S, H, D = value.shape
    Q, L, P = loc.shape[1], loc.shape[3], loc.shape[4]
    grids = 2 * loc - 1
    sampled, pos = [], 0
    for lvl, (h, w) in enumerate(shapes):
        v = value[:, pos:pos + h * w].float().permute(0, 2, 3, 1).reshape(
            B * H, D, h, w)
        pos += h * w
        grid = grids[:, :, :, lvl].transpose(1, 2).reshape(B * H, Q, P, 2)
        sampled.append(F.grid_sample(v, grid, mode="bilinear",
                                     padding_mode="zeros",
                                     align_corners=False))  # [BH, D, Q, P]
    a = attw.transpose(1, 2).reshape(B * H, 1, Q, L * P)
    out = (torch.stack(sampled, -2).flatten(-2) * a).sum(-1)
    return out.reshape(B, H * D, Q).transpose(1, 2)


def msda_valid_corners(shapes, loc):
    """Corner samples inside the map: what this input's gathers need."""
    n = 0
    for lvl, (h, w) in enumerate(shapes):
        x = loc[:, :, :, lvl, :, 0] * w - 0.5
        y = loc[:, :, :, lvl, :, 1] * h - 0.5
        x0, y0 = torch.floor(x), torch.floor(y)
        for dy in (0, 1):
            for dx in (0, 1):
                ok = ((x0 + dx >= 0) & (x0 + dx <= w - 1)
                      & (y0 + dy >= 0) & (y0 + dy <= h - 1))
                n += int(ok.sum().item())
    return n


def msda_shape(value, loc):
    B, S, H, D = value.shape
    return {"B": B, "S": S, "Q": loc.shape[1], "H": H, "D": D,
            "L": loc.shape[3], "P": loc.shape[4]}


def check_msda_calls(cases, kernel_name, want_kernels):
    """Each MSDA case's call launches only the design's kernels:
    `want_kernels` kernels a call at most (fewer only where the profiler
    dropped an event), all of them the port's or memsets."""
    for case in cases:
        names = case["kernel_names"]
        if not (0 < case["kernels_per_call"] <= want_kernels and all(
                kernel_name in n or "cast_bf16_kernel" in n
                or "Memset" in n for n in names)):
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call: "
                                 f"{names}")


def check_msda(g):
    """The MSDA forward kernel against the plain version at the main-path
    shapes, on uniform locations and on the inputs captured from a det
    request; each output also bit-identical across two calls. The
    grid_sample composition is the yardstick (`composite_*`)."""
    cases, timed = [], {}
    inputs = list(msda_uniform_cases(g, bwd=False)) + captured_msda_fwd()
    for name, value, shapes, loc, attw in inputs:
        got = M.ms_deform_attn(value, shapes, loc, attw)
        again = M.ms_deform_attn(value, shapes, loc, attw)
        want = M.ms_deform_attn_plain(value, shapes, loc, attw)
        comp = functools.partial(msda_composite, value, shapes, loc, attw)
        torch.cuda.synchronize()
        err = check_close(f"ms_deform_attn[{name}]", got, want)
        if not torch.equal(got, again):
            raise AssertionError(f"ms_deform_attn[{name}]: two calls differ")
        comp_err = check_close(f"msda_composite[{name}]", comp(), want)
        D = value.shape[3]
        n_loc = attw.numel()
        flops = 2 * D * msda_valid_corners(shapes, loc) + 20 * n_loc
        nbytes = (2 * value.numel() + 4 * loc.numel() + 4 * attw.numel()
                  + 2 * got.numel())
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        kernel = functools.partial(M.ms_deform_attn, value, shapes, loc,
                                   attw)
        case = {
            "case": name, "shape": msda_shape(value, loc),
            "max_abs_err": err, "repeat_bit_identical": True,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: M.ms_deform_attn_plain(
                value, shapes, loc, attw), n=5),
            "library_ms": None, "composite_ms": cuda_ms(comp),
            "composite_max_abs_err": comp_err,
            "composite": "F.grid_sample per level + weighted sum",
            "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":composite"] = kernel, comp
        cases.append(case)
    device_ms_update(cases, timed)
    del timed, inputs
    for case in cases:
        emit({"phase": "kernel", "kernel": "ms_deform_attn_fwd", **case})
    check_msda_calls(cases, "msda_fwd", 1)
    return cases


def check_attention_bwd(g):
    """The flash backward kernel against autograd of the plain forward,
    at the forward's cases; the library yardstick is the backward of
    `scaled_dot_product_attention` through `torch.autograd.grad`. Every
    case's device time comes from one profiler context, which also counts
    the kernels a call launches on each side."""
    cases, timed = [], {}
    for name, q, k, v, causal, seg in attention_cases(g):
        B, L, H, D = q.shape
        Hkv = k.shape[2]
        dout = torch.randn(q.shape, generator=g, device="cuda").to(
            torch.bfloat16)
        lse = torch.empty(B, H, L, dtype=torch.float32, device="cuda")
        out = A._launch_fwd(q, k, v, causal, seg, lse)
        got = A.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                    segment_ids=seg)
        want = A.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                           segment_ids=seg)
        torch.cuda.synchronize()
        errs = {n: check_close(f"flash_attention_bwd[{name}].{n}", a, b)
                for n, a, b in zip(("dq", "dk", "dv"), got, want)}
        qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        mask = None
        if seg is not None:
            mask = (seg[:, None, :, None] == seg[:, None, None, :]) & \
                torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
        if mask is None:
            lib_out = F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=causal, enable_gqa=Hkv != H)
        else:
            lib_out = F.scaled_dot_product_attention(qh, kh, vh,
                                                     attn_mask=mask)
        lib = functools.partial(torch.autograd.grad, lib_out, (qh, kh, vh),
                                dout.transpose(1, 2), retain_graph=True)
        for n, a, b in zip(("dq", "dk", "dv"), lib(), want):
            check_close(f"sdpa_bwd[{name}].{n}", a.transpose(1, 2), b)
        pairs = sum(attention_pairs(L, causal, seg)) * H
        flops = 10 * pairs * D     # S again, dP, dV, dQ, dK
        nbytes = 2 * 4 * (q.numel() + k.numel()) + 4 * lse.numel() + \
            (0 if seg is None else seg.numel() * 4)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        kernel = functools.partial(A.flash_attention_bwd, q, k, v, out, dout,
                                   lse, causal=causal, segment_ids=seg)
        case = {
            "case": name, "shape": [B, L, H, Hkv, D], "causal": causal,
            "segment_ids": seg is not None, "max_abs_err": max(errs.values()),
            "max_abs_err_by_output": errs,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: A.flash_attention_bwd_plain(
                q, k, v, dout, causal=causal, segment_ids=seg), n=5),
            "library_ms": cuda_ms(lib),
            "library": "scaled_dot_product_attention backward",
            "bound_ms": b_ms, "bound_by": b_by, "flops": flops,
            "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":library"] = kernel, lib
        cases.append(case)
    device_ms_update(cases, timed)
    del timed                     # and with it the SDPA graphs
    for case in cases:
        # every wrapper call launches the design's kernels, and only them
        if case["kernels_per_call"] != FLASH_BWD_KERNELS or not all(
                "flash_bwd" in n for n in case["kernel_names"]):
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call "
                                 f"({case['kernel_names']}), not "
                                 f"{FLASH_BWD_KERNELS}")
        emit({"phase": "kernel", "kernel": "flash_attn_bwd", **case})
    return cases


def check_msda_bwd(g):
    """The MSDA backward kernel against autograd of the plain forward at
    the 640 px train shapes, on uniform locations and on the inputs (and
    grad_out) captured from a train step; grad_loc and grad_attw
    bit-identical across two calls, grad_value's spread across them
    reported (fp32 atomics). The yardstick is autograd of the grid_sample
    composition (`composite_*`)."""
    cases, timed = [], {}
    inputs = list(msda_uniform_cases(g, bwd=True)) + captured_msda_bwd()
    names = ("grad_value", "grad_loc", "grad_attw")
    for name, value, shapes, loc, attw, gout in inputs:
        got = M.ms_deform_attn_bwd(value, shapes, loc, attw, gout)
        again = M.ms_deform_attn_bwd(value, shapes, loc, attw, gout)
        want = M.ms_deform_attn_bwd_plain(value, shapes, loc, attw, gout)
        torch.cuda.synchronize()
        errs = {n: check_close(f"ms_deform_attn_bwd[{name}].{n}", a, b)
                for n, a, b in zip(names, got, want)}
        for n, a, b in zip(names[1:], got[1:], again[1:]):
            if not torch.equal(a, b):
                raise AssertionError(f"ms_deform_attn_bwd[{name}].{n}: two "
                                     "calls differ")
        spread = (got[0].float() - again[0].float()).abs()
        ins = [value.float().requires_grad_(), loc.clone().requires_grad_(),
               attw.clone().requires_grad_()]
        comp_out = msda_composite(ins[0], shapes, ins[1], ins[2])
        comp = functools.partial(torch.autograd.grad, comp_out, ins,
                                 gout.float(), retain_graph=True)
        # grad_loc jumps where a location crosses a cell edge, and
        # grid_sample's pixel ((2 t - 1 + 1) W - 1) / 2 rounds otherwise
        # than t W - 0.5 there: its grad_loc error is reported, not held
        comp_got = comp()
        comp_errs = {n: (a.float() - b.float()).abs().max().item()
                     for n, a, b in zip(names, comp_got, want)}
        for i in (0, 2):
            check_close(f"msda_composite_bwd[{name}].{names[i]}",
                        comp_got[i], want[i])
        del comp_got
        D = value.shape[3]
        valid = msda_valid_corners(shapes, loc)
        # per valid corner and channel: the value-gradient product and
        # its add, and the FMAs of the weight and two location sums
        flops = 8 * D * valid + 30 * attw.numel()
        nbytes = (2 * 2 * value.numel() + 2 * 4 * loc.numel()
                  + 2 * 4 * attw.numel() + 2 * gout.numel())
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        kernel = functools.partial(M.ms_deform_attn_bwd, value, shapes, loc,
                                   attw, gout)
        case = {
            "case": name, "shape": msda_shape(value, loc),
            "max_abs_err": max(errs.values()),
            "max_abs_err_by_output": errs,
            "grad_value_repeat_max_abs_diff": spread.max().item(),
            "grad_value_repeat_elements_differing":
                int((spread > 0).sum().item()),
            "valid_corners": valid, "vector_reductions": valid * D // 4,
            "ms": cuda_ms(kernel),
            "plain_ms": cuda_ms(lambda: M.ms_deform_attn_bwd_plain(
                value, shapes, loc, attw, gout), n=3, warmup=1),
            "library_ms": None, "composite_ms": cuda_ms(comp),
            "composite_max_abs_err_by_output": comp_errs,
            "composite": "autograd of F.grid_sample per level + weighted sum",
            "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        timed[name + ":kernel"], timed[name + ":composite"] = kernel, comp
        cases.append(case)
    device_ms_update(cases, timed)
    del timed, inputs
    for case in cases:
        emit({"phase": "kernel", "kernel": "ms_deform_attn_bwd", **case})
    # the memset of the fp32 scratch, the kernel, the cast to bf16
    check_msda_calls(cases, "msda_bwd", 3)
    return cases


def check_gathers():
    """The two gather probes' kernels against their plain versions at the
    probe's shapes (exact), with `torch.gather` / `torch.index_select` as
    the library yardsticks; device times of both probes from one profiler
    context."""
    lane, row, timed = [], [], {}
    for E in probes.LANE_EXTENTS:
        v, idx = probes.lane_inputs(E, "cuda")
        idx64 = idx.long()
        got = G.lane_gather(v, idx)
        want = G.lane_gather_plain(v, idx)
        torch.cuda.synchronize()
        err = check_close(f"lane_gather[{E}]", got, want)
        if not torch.equal(got, want):
            raise AssertionError(f"lane_gather[{E}] differs from plain")
        nbytes = 3 * 4 * v.numel()
        b_ms, b_by = bound(nbytes, 0, FP32_FLOPS)
        kernel = functools.partial(G.lane_gather, v, idx)
        lib = functools.partial(torch.gather, v, 1, idx64)
        case = {"case": f"extent_{E}", "shape": list(v.shape),
                "max_abs_err": err,
                "ms": cuda_ms(kernel),
                "plain_ms": cuda_ms(lambda: G.lane_gather_plain(v, idx)),
                "library_ms": cuda_ms(lib),
                "library": "torch.gather", "bound_ms": b_ms,
                "bound_by": b_by, "bytes": nbytes}
        timed[case["case"] + ":kernel"] = kernel
        timed[case["case"] + ":library"] = lib
        lane.append(case)
    for n in (8192, probes.N):
        table, idx = probes.row_inputs(n, "cuda")
        for rpb in (8, 64):
            got = G.row_gather(table, idx, rpb)
            want = G.row_gather_plain(table, idx)
            torch.cuda.synchronize()
            err = check_close(f"row_gather[{n}, {rpb}]", got, want)
            if not torch.equal(got, want):
                raise AssertionError(f"row_gather[{n}, {rpb}] differs")
            # the table, the indices and the rows out, each once (the
            # 4 MB table sits in L2 for the repeated row reads)
            nbytes = 2 * table.numel() + 4 * n + 2 * got.numel()
            b_ms, b_by = bound(nbytes, 0, BF16_TENSOR_FLOPS)
            kernel = functools.partial(G.row_gather, table, idx, rpb)
            lib = functools.partial(torch.index_select, table, 0, idx)
            ms = cuda_ms(kernel)
            lib_ms = cuda_ms(lib)
            case = {"case": f"n{n}_rpb{rpb}", "shape": [n, *table.shape],
                    "max_abs_err": err, "ms": ms,
                    "plain_ms": cuda_ms(lambda: G.row_gather_plain(table,
                                                                   idx)),
                    "library_ms": lib_ms, "library": "torch.index_select",
                    "rows_per_s": n / (ms * 1e-3),
                    "library_rows_per_s": n / (lib_ms * 1e-3),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes}
            timed[case["case"] + ":kernel"] = kernel
            timed[case["case"] + ":library"] = lib
            row.append(case)
    device_ms_update(lane + row, timed)
    for case in lane:
        emit({"phase": "kernel", "kernel": "lane_gather", **case})
    for case in row:
        emit({"phase": "kernel", "kernel": "row_gather", **case})
    return lane, row


def rotating_ms(fn, sets, n=20):
    """Mean device ms of fn over rotating argument sets: with more bytes
    in the sets than the L2 holds, each call reads its weights cold, as
    the decode loop does."""
    return cuda_ms(rotating(fn, sets), n=n)


def rotating(fn, sets):
    """fn over the argument sets in turn, one set a call."""
    it = itertools.count()
    return lambda: fn(*sets[next(it) % len(sets)])


def int4_dequant(wp, scale):
    """bf16 [K, N] weights of a packed tree (the library yardstick's
    input; computed outside any timed region)."""
    G = 2 * wp.shape[0] // scale.shape[0]
    wi = wp.to(torch.int32)
    w = torch.cat([((wi & 0xF) ^ 8) - 8, wi >> 4], 0).float()
    return (w * scale.float().repeat_interleave(G, 0)).to(torch.bfloat16)


def check_int4(g):
    cases, timed = [], {}
    specs = [(f"decode_m{m}_{k}x{n}", m, k, n)
             for m in (1, 4) for k, n in ((4096, 4096), (4096, 11008),
                                           (11008, 4096), (4096, 32096))]
    specs.append(("prefill_m2560_4096x11008", 2560, 4096, 11008))
    for name, M_, K, N in specs:
        wbytes = K * N // 2 + 2 * (K // 128) * N
        copies = max(1, math.ceil(2 * L2_BYTES / wbytes)) \
            if M_ <= 8 else 1
        packed = [Q.pack_int4(torch.randn(K, N, generator=g, device="cuda")
                              * K ** -0.5) for _ in range(copies)]
        x = torch.randn(M_, K, generator=g, device="cuda").to(torch.bfloat16)
        wp, scale = packed[0]
        got = Q.int4_matmul(x, wp, scale)
        want = Q.int4_matmul_plain(x, wp, scale)
        torch.cuda.synchronize()
        err = check_close(f"int4_matmul[{name}]", got, want)
        lib_copies = max(1, math.ceil(copies * wbytes / (2 * K * N)))
        deq = [int4_dequant(*packed[i % copies]) for i in range(lib_copies)]
        torch.cuda.synchronize()
        check_close(f"matmul[{name}]", torch.matmul(x, deq[0]), want)
        sets = [(x, wp_, s_) for wp_, s_ in packed]
        lib_sets = [(x, d) for d in deq]
        nbytes = 2 * M_ * K + wbytes + 2 * M_ * N
        b_ms, b_by = bound(nbytes, 2 * M_ * K * N, BF16_TENSOR_FLOPS)
        case = {
            "case": name, "shape": [M_, K, N], "max_abs_err": err,
            "ms": rotating_ms(Q.int4_matmul, sets),
            "plain_ms": rotating_ms(Q.int4_matmul_plain, sets, n=5),
            "library_ms": rotating_ms(torch.matmul, lib_sets),
            "library": "torch.matmul(x, dequantized bf16 W)",
            "bound_ms": b_ms, "bound_by": b_by,
            "flops": 2 * M_ * K * N, "bytes": nbytes,
            "weight_copies_rotated": copies}
        timed[name + ":kernel"] = rotating(Q.int4_matmul, sets)
        timed[name + ":library"] = rotating(torch.matmul, lib_sets)
        cases.append(case)
    # device time per call, all cases in one profiler session (the
    # rotated copies stay alive until it ends)
    device_ms_update(cases, timed)
    for case in cases:
        emit({"phase": "kernel", "kernel": "int4_matmul", **case})
    for case in cases:
        # one kernel a call: no split-K partials, no second pass. Every
        # kernel in a case's range is the int4 kernel, at most one a call
        # (fewer only where the profiler dropped an event)
        names = case["kernel_names"]
        if not (0 < case["kernels_per_call"] <= 1 and names
                and all("int4_mma_kernel" in k for k in names)):
            raise AssertionError(f"device_ms[{case['case']}]: "
                                 f"{case['kernels_per_call']} kernels a call: "
                                 f"{names}")
    del timed
    torch.cuda.empty_cache()
    return cases


# ---------------------------------------------------------------------------
# phase 4: the det slice at full width
# ---------------------------------------------------------------------------

def make_requests(cfg, tid, g):
    img_len = cfg.vis_encoder.num_patches
    size = cfg.vis_encoder.image_size
    embs = [tid.emb + i for i in range(cfg.num_embs)]
    reqs = []
    for r in range(N_REQUESTS):
        ids = [1, 10, 11] + [tid.imp] * img_len + [12] + [tid.det] + embs
        if r == N_REQUESTS - 1:          # two [DET][EMB x4] groups
            ids += [13, tid.det] + embs
        ids += [2]
        reqs.append((
            torch.tensor([ids], dtype=torch.long, device="cuda"),
            (0.3 * torch.randn(1, size, size, 3, generator=g,
                               device="cuda")).to(torch.bfloat16),
            (0.3 * torch.randn(1, DET_SIZE, DET_SIZE, 3, generator=g,
                               device="cuda")).to(torch.bfloat16)))
    return reqs


def text_queries(model, ids, images, tid):
    out = model.core(ids, images, tid, compute_logits=False)
    return model.core.extract_text_query(out["hidden"], ids, tid)


def run_slice():
    cfg = vllm_7b_det_config()
    tid = SpecialTokenIds.synthetic()
    t = time.perf_counter()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    g = torch.Generator(device="cuda").manual_seed(1)
    reqs = make_requests(cfg, tid, g)
    per_req_flash = cfg.vis_encoder.num_layers + cfg.llm.num_layers
    per_req_msda = cfg.gdino.encoder_layers + cfg.gdino.decoder_layers
    Q, T = cfg.gdino.num_queries, cfg.gdino.max_text_len
    side = DET_SIZE // 4

    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    M.ms_deform_attn.launches = 0
    outs, per_request = [], []
    with torch.no_grad():
        for ids, images, aug in reqs:
            f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
            outs.append(model.infer_det(ids, images, aug, tid))
            per_request.append((A.flash_attention.launches - f0,
                                M.ms_deform_attn.launches - m0))
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "ms_deform_attn_fwd": M.ms_deform_attn.launches}
    for n_f, n_m in per_request:
        if (n_f, n_m) != (per_req_flash, per_req_msda):
            raise AssertionError(f"launches per request {(n_f, n_m)} != "
                                 f"{(per_req_flash, per_req_msda)}")
    for out in outs:
        for key, shape in (("logits", (1, Q, T)), ("pred_boxes", (1, Q, 4)),
                           ("pred_masks", (1, Q, side, side))):
            x = out[key]
            if tuple(x.shape) != shape or not torch.isfinite(x).all():
                raise AssertionError(f"{key}: shape {tuple(x.shape)} vs "
                                     f"{shape}, finite "
                                     f"{bool(torch.isfinite(x).all())}")
        if not ((out["pred_boxes"] >= 0) & (out["pred_boxes"] <= 1)).all():
            raise AssertionError("pred_boxes outside [0, 1]")

    # the same requests with the plain versions in place of both kernels
    tq_errs, agree, box_errs = [], [], []
    with torch.no_grad():
        for (ids, images, aug), out in zip(reqs, outs):
            tq_k, mask_k = text_queries(model, ids, images, tid)
            with mock.patch.object(A, "flash_attention",
                                   A.flash_attention_plain), \
                    mock.patch.object(M, "ms_deform_attn",
                                      M.ms_deform_attn_plain):
                tq_p, mask_p = text_queries(model, ids, images, tid)
                out_p = model.gdino(aug, tq_p, mask_p)
            if not torch.equal(mask_k, mask_p):
                raise AssertionError("text-query masks differ")
            rel = ((tq_k.float() - tq_p.float()).norm()
                   / tq_p.float().norm()).item()
            if not rel <= TQ_REL_TOL:
                raise AssertionError(f"text queries: rel err {rel} > "
                                     f"{TQ_REL_TOL}")
            tq_errs.append(rel)
            ik, ip = out["topk_idx"][0], out_p["topk_idx"][0]
            agree.append(len(set(ik.tolist()) & set(ip.tolist())) / Q)
            # boxes of the query slots that selected the same proposal
            same = ik == ip
            box_errs.append((out["pred_boxes"][0, same]
                             - out_p["pred_boxes"][0, same])
                            .abs().median().item())

    # warm timings: a request and its stages (host clock, synced)
    ids, images, aug = reqs[0]
    with torch.no_grad():
        req_ms = host_ms(lambda: model.infer_det(ids, images, aug, tid))
        vision_ms = host_ms(lambda: model.core.encode_images(images))
        embeds, _ = model.core.build_prompt_embeds(ids, images, tid)
        pos = torch.arange(ids.shape[1], device="cuda")[None]
        prefill_ms = host_ms(lambda: model.core.llm(
            embeds, pos, compute_logits=False))
        tq, tq_mask = text_queries(model, ids, images, tid)
        gdino_ms = host_ms(lambda: model.gdino(aug, tq, tq_mask))
    emit({"phase": "slice", "requests": N_REQUESTS,
          "prompt_tokens": [int(r[0].shape[1]) for r in reqs],
          "params": n_params, "build_model_s": build_s,
          "launches_per_request": per_request, "launches": launches,
          "text_query_rel_err": tq_errs, "text_query_rel_tol": TQ_REL_TOL,
          "topk_agreement": agree,
          "pred_boxes_same_slot_median_abs_diff": box_errs,
          "request_ms_median": req_ms, "vision_ms": vision_ms,
          "prefill_ms": prefill_ms, "gdino_ms": gdino_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_request(model, reqs[0], tid)
    return launches


def profile_request(model, req, tid):
    """One warm det request under torch.profiler."""
    ids, images, aug = req
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.infer_det(ids, images, aug, tid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "profile", **device_summary(prof, wall_ms)})


# the port's own kernels (csrc/*.cu, each in an anonymous namespace), as
# the profiler names them: "(anonymous namespace)::<name>[<args>](...)",
# where the template arguments are integers, bools or int4's tile
# "(anonymous namespace)::Cfg<integers>" (PyTorch's anonymous-namespace
# kernels take types)
PORT_KERNEL = re.compile(
    r"(?:^|\s)\(anonymous namespace\)::(\w+(?:<(?:[\d ,]|true|false|"
    r"\(anonymous namespace\)::\w+<[\d ,]+>)+>)?)\(")


def device_summary(prof, wall_ms):
    """Summed device kernel time (one stream, so their union), the
    device's idle share of the wall, the kernels that take the most, and
    every kernel of the port's own."""
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.device_time_total / 1e3, n + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    port = {}
    for k, (t, n) in by_name.items():
        m = PORT_KERNEL.search(k)
        if m:
            name = m.group(1).replace("(anonymous namespace)::", "")
            pt, pn = port.get(name, (0.0, 0))
            port[name] = (pt + t, pn + n)
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_kernels": sum(n for _, n in by_name.values()),
            "top_kernels": [{"name": k[:90], "ms": t, "count": n}
                            for k, (t, n) in top],
            "port_kernels": [{"name": k, "ms": t, "count": n}
                             for k, (t, n) in sorted(port.items())]}


# ---------------------------------------------------------------------------
# phases 8-9: the det training step at full width and depth
# ---------------------------------------------------------------------------

def train_batch(cfg, tid, g):
    """bench_train.py's det batch at bs 1: the 586-token prompt, CLIP and
    640 px det pixels, 20 targets (boxes from numpy seed 0, full masks)."""
    img_len = cfg.vis_encoder.num_patches
    ids = ([1, 10, 11] + [tid.imp] * img_len + [12] + [tid.det]
           + [tid.emb + i for i in range(cfg.num_embs)] + [2])
    input_ids = torch.tensor([ids], dtype=torch.long, device="cuda")
    rng = np.random.default_rng(0)
    cxcy = rng.uniform(0.3, 0.7, (1, TRAIN_TARGETS, 2))
    wh = rng.uniform(0.05, 0.25, (1, TRAIN_TARGETS, 2))
    size = cfg.vis_encoder.image_size
    return {
        "input_ids": input_ids,
        "labels": torch.where(input_ids >= 10, input_ids,
                              torch.full_like(input_ids, -100)),
        "attn_mask": torch.ones_like(input_ids),
        "images": (0.5 * torch.randn(1, size, size, 3, generator=g,
                                     device="cuda")).to(torch.bfloat16),
        "images_aug": (0.5 * torch.randn(1, TRAIN_DET, TRAIN_DET, 3,
                                         generator=g, device="cuda")
                       ).to(torch.bfloat16),
        "targets": {
            "labels": torch.zeros(1, TRAIN_TARGETS, dtype=torch.long,
                                  device="cuda"),
            "boxes": torch.tensor(np.concatenate([cxcy, wh], -1),
                                  dtype=torch.float32, device="cuda"),
            "valid": torch.ones(1, TRAIN_TARGETS, dtype=torch.bool,
                                device="cuda"),
            "masks": torch.ones(1, TRAIN_TARGETS, TRAIN_DET // 4,
                                TRAIN_DET // 4, device="cuda"),
        },
    }


TRAIN_KERNELS = (("flash_attn_fwd", A.flash_attention),
                 ("flash_attn_bwd", A.flash_attention_bwd),
                 ("ms_deform_attn_fwd", M.ms_deform_attn),
                 ("ms_deform_attn_bwd", M.ms_deform_attn_bwd))


def train_counts():
    return tuple(fn.launches for _, fn in TRAIN_KERNELS)


def loss_and_grad(model, batch, tid, noise, trainable, choices=None):
    """One det step's loss terms and fp32 trainable gradients by name (no
    optimizer step), and the discrete choices it made (or repeated)."""
    for p in trainable.values():
        p.grad = None
    loss, metrics, choices = det_loss(model, batch, tid, noise, choices)
    loss.backward()
    grads = {n: (p.grad if p.grad is not None
                 else torch.zeros_like(p)).float()
             for n, p in trainable.items()}
    for p in trainable.values():
        p.grad = None
    return {k: v.item() for k, v in metrics.items()}, grads, choices


def grad_groups(gk, gp):
    """Relative L2 error of the gradients `gk` against `gp` and the norm
    of `gp`, by module (the first two parts of the parameter path), and
    the relative L2 error of the whole concatenated gradient."""
    acc = {}
    for n in gp:
        key = ".".join(n.split(".")[:2])
        d, w = acc.get(key, (0.0, 0.0))
        acc[key] = (d + (gk[n] - gp[n]).square().sum().item(),
                    w + gp[n].square().sum().item())
    total = math.sqrt(sum(d for d, _ in acc.values())
                      / sum(w for _, w in acc.values()))
    return {k: {"rel": math.sqrt(d / w) if w else 0.0, "norm": math.sqrt(w)}
            for k, (d, w) in sorted(acc.items())}, total


def plain_backwards():
    """The kernels' forwards with the plain versions' backwards: the two
    backward wrappers the autograd functions call become autograd of the
    plain forwards at the same inputs."""
    stack = ExitStack()
    stack.enter_context(mock.patch.object(
        A, "flash_attention_bwd",
        lambda q, k, v, out, dout, lse, causal=False, segment_ids=None:
        A.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                    segment_ids=segment_ids)))
    stack.enter_context(mock.patch.object(M, "ms_deform_attn_bwd",
                                          M.ms_deform_attn_bwd_plain))
    return stack


def build_train():
    """The train phase's model (seed 0), optimizer, state and step: the
    stage-1 frozen `vllm_7b_det_config()`."""
    cfg = vllm_7b_det_config()
    tid = SpecialTokenIds.synthetic()
    model = build_model(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    # reference stage 1: vision encoder and LLM frozen
    frozen = frozen_predicate(TrainConfig(freeze_llm=True), cfg)
    tx = build_optimizer(OptimizerConfig(total_steps=1000), model, frozen)
    state = TrainState.create(model, tx, frozen)
    step = make_det_train_step(model, tx, tid, frozen)
    return cfg, tid, model, state, step


def run_train():
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    cfg, tid, model, state, step = build_train()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    n_params = sum(p.numel() for p in model.parameters())
    n_train = sum(w.numel() for w in state.masters.values())
    g = torch.Generator(device="cuda").manual_seed(2)
    batch = train_batch(cfg, tid, g)
    per_step = (cfg.vis_encoder.num_layers + cfg.llm.num_layers,
                cfg.llm.num_layers,
                cfg.gdino.encoder_layers + cfg.gdino.decoder_layers,
                cfg.gdino.encoder_layers + cfg.gdino.decoder_layers)

    # one step's losses and gradient, kernels against plain versions, from
    # the same weights, batch and draws, and on the kernel run's discrete
    # choices (top-k proposals, matchings, mask points), which bf16
    # near-ties could otherwise flip between the runs. The loss terms are
    # held against the all-plain step. The gradient is held against the
    # step whose forward is the kernels' and whose backward is the plain
    # versions' (autograd of the plain forwards at the same inputs): with
    # random weights the gradient is chaotic in the forward's last-bit
    # rounding (the all-plain step's, reported, moves it by ~13 % while
    # its text queries move by 1.5 %), which says nothing of a backward
    # kernel.
    trainable = {n: p for n, p in model.named_parameters()
                 if n in state.masters}
    noise = draw_step_noise(g, cfg.gdino, batch["targets"])
    mk, gk, choices = loss_and_grad(model, batch, tid, noise, trainable)
    with plain_versions():
        mp, gp, _ = loss_and_grad(model, batch, tid, noise, trainable,
                                  choices)
    with plain_backwards():
        _, gb, _ = loss_and_grad(model, batch, tid, noise, trainable,
                                 choices)
    loss_rel = {k: abs(mk[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp}
    groups, grad_rel = grad_groups(gk, gb)
    _, grad_rel_all_plain = grad_groups(gk, gp)
    emit({"phase": "train_compare", "loss_terms_kernel": mk,
          "loss_terms_plain": mp, "loss_rel_err": loss_rel,
          "grad_rel_err_plain_backward": grad_rel,
          "grad_rel_err_all_plain": grad_rel_all_plain,
          "grad_by_module": groups})
    if not (max(loss_rel.values()) <= TRAIN_REL_TOL
            and grad_rel <= TRAIN_REL_TOL):
        raise AssertionError(f"train step kernel vs plain: loss terms "
                             f"{loss_rel}, gradient {grad_rel} (tol "
                             f"{TRAIN_REL_TOL})")
    if not all(math.isfinite(v) for v in mk.values()):
        raise AssertionError(f"non-finite loss terms {mk}")
    del gk, gp, gb

    frozen_before = {n: p.detach().clone() for n, p in model.named_parameters()
                     if n not in state.masters}
    masters_before = {n: w.clone() for n, w in state.masters.items()}
    train_before = {n: p.detach().clone() for n, p in trainable.items()}

    # the main path: TRAIN_STEPS AdamW steps, counts taken around them
    for _, fn in TRAIN_KERNELS:
        fn.launches = 0
    step_ms, counts, losses = [], [], []
    for _ in range(TRAIN_STEPS):
        c0 = train_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, metrics = step(state, batch, generator=g)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        counts.append(tuple(b - a for a, b in zip(c0, train_counts())))
        losses.append({k: v.item() for k, v in metrics.items()})
    launches = {name: fn.launches for name, fn in TRAIN_KERNELS}
    if any(c != per_step for c in counts):
        raise AssertionError(f"launches per step {counts} != {per_step}")
    if not all(math.isfinite(v) for m in losses for v in m.values()):
        raise AssertionError(f"non-finite losses {losses}")
    # the fp32 masters move every step; a bf16 parameter moves once its
    # master has crossed half a bf16 step (norm weights at 1.0 need more
    # than these few lr-2e-5 steps)
    moved = sum(not torch.equal(w, masters_before[n])
                for n, w in state.masters.items())
    moved_bf16 = sum(not torch.equal(p.detach(), train_before[n])
                     for n, p in trainable.items())
    if moved < 0.9 * len(trainable):
        raise AssertionError(f"only {moved} of {len(trainable)} trainable "
                             "masters moved")
    params = dict(model.named_parameters())
    changed = [n for n, w in frozen_before.items()
               if not torch.equal(params[n].detach(), w)]
    if changed:
        raise AssertionError(f"frozen parameters changed: {changed[:5]}")
    del frozen_before, train_before, masters_before
    emit({"phase": "train", "config": "vllm_7b_det_config() stage 1",
          "llm_layers": cfg.llm.num_layers, "det_size": TRAIN_DET,
          "prompt_tokens": int(batch["input_ids"].shape[1]),
          "targets": TRAIN_TARGETS, "dn_number": cfg.gdino.dn_number,
          "mask_points": cfg.gdino.num_mask_points,
          "params": n_params, "trainable": n_train,
          "trainable_tensors": len(trainable), "moved_masters": moved,
          "moved_bf16_params": moved_bf16,
          "build_s": build_s,
          "plain_loss_rel_err": loss_rel,
          "plain_backward_grad_rel_err": grad_rel,
          "all_plain_grad_rel_err": grad_rel_all_plain,
          "rel_tol": TRAIN_REL_TOL,
          "launches_per_step": dict(zip([n for n, _ in TRAIN_KERNELS],
                                        counts[0])),
          "launches": launches, "step_ms": step_ms,
          "step_ms_median_2_to_5": statistics.median(step_ms[1:]),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "loss_trace": [m["loss"] for m in losses], "last_step": losses[-1],
          "kernel_step_terms": mk})
    profile_train_step(step, state, batch, g)
    return launches


def profile_train_step(step, state, batch, g):
    """One more train step under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, batch, generator=g)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "train_profile", **device_summary(prof, wall_ms)})


# ---------------------------------------------------------------------------
# phase 10: the gather probes' entry point
# ---------------------------------------------------------------------------

def run_probes():
    G.lane_gather.launches = 0
    G.row_gather.launches = 0
    res = probes.main("cuda")
    launches = {"lane_gather": G.lane_gather.launches,
                "row_gather": G.row_gather.launches}
    bad = [r for r in res["A"] + res["B"] if not r["correct"]]
    if bad:
        raise AssertionError(f"probes gave wrong results: {bad}")
    emit({"phase": "probes", "launches": launches, **res})
    return launches


# ---------------------------------------------------------------------------
# phases 6-7: int4 chat serving at full width
# ---------------------------------------------------------------------------

def serve_requests():
    """The serve phase's requests: 4 image requests, a text-only request
    with a history (uint8 images from a numpy seed)."""
    rng = np.random.RandomState(0)
    shapes = ((480, 640, 3), (336, 336, 3), (600, 400, 3), (224, 300, 3))
    prompts = ("describe the image", "what color is the car",
               "how many people are there", "where was this photo taken")
    images = [dict(prompt=p, image=rng.randint(0, 255, sh, np.uint8))
              for p, sh in zip(prompts, shapes)]
    text = dict(prompt="and what should I bring",
                history=["I plan a trip to the mountains",
                         "that sounds great, when do you leave",
                         "next week", "pack warm clothes"])
    return images, text


def post_json(url, obj):
    req = urllib.request.Request(url, json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def teacher_forced(svc, ids, imgs, mask, tokens, n_gen, step_ms=None):
    """Prefill + (n_gen - 1) decode steps of `svc`'s core, fed the tokens
    `tokens` [B, >= n_gen] emitted by a generate call (through the same
    emb-countdown state machine), returning each step's last-position
    fp32 logits [n_gen, B, V]. Appends each decode step's synced wall ms
    to `step_ms` when given."""
    core, tid, cfg = svc.core, svc.tid, svc.core.cfg
    B, L = ids.shape
    max_len = svc.max_prompt + svc.max_new_tokens + 8
    cache = KVCache.create(cfg.llm, B, max_len, torch.bfloat16, ids.device)
    out = core(ids, imgs, tid, attn_mask=mask, cache=cache)
    logits = [out["logits"][:, -1].float()]
    first = tokens[:, 0]
    kind = _tool_kind(first, tid)
    total = torch.where(kind >= C.TOOL_GEN,
                        torch.full_like(kind, cfg.num_embs_gen),
                        torch.full_like(kind, cfg.num_embs))
    countdown = torch.where(kind > 0, total, torch.zeros_like(kind))
    embed = core.embed_tokens(first[:, None].long())
    dmask = torch.cat([mask, torch.ones(B, max_len - L, dtype=torch.bool,
                                        device=ids.device)], 1)
    for step in range(1, n_gen):
        torch.cuda.synchronize()
        t = time.perf_counter()
        pos = torch.full((B, 1), cache.index, dtype=torch.long,
                         device=ids.device)
        res = core.llm_step(embed, pos, cache, dmask)
        _, embed, countdown, kind = advance_tool_state(
            core, tid, cfg.num_embs, cfg.num_embs_gen, tokens[:, step],
            countdown, kind)
        torch.cuda.synchronize()
        if step_ms is not None:
            step_ms.append((time.perf_counter() - t) * 1e3)
        logits.append(res["logits"][:, -1].float())
    return torch.stack(logits)


def plain_versions():
    stack = ExitStack()
    stack.enter_context(mock.patch.object(A, "flash_attention",
                                          A.flash_attention_plain))
    stack.enter_context(mock.patch.object(M, "ms_deform_attn",
                                          M.ms_deform_attn_plain))
    stack.enter_context(mock.patch.object(Q, "int4_matmul",
                                          Q.int4_matmul_plain))
    return stack


def compare_plain(svc, reqs):
    """One generate call of `reqs` with the kernels, then the kernel run
    and the plain run teacher-forced on its tokens: per-step relative
    error of the logits (live rows) and top-1 agreement."""
    ids, imgs, mask, live = svc._pack(reqs)
    out = svc.generate_fn(ids, imgs, attn_mask=mask, live=live)
    n_gen = int(out["num_generated"])
    toks = out["out_tokens"]
    lk = teacher_forced(svc, ids, imgs, mask, toks, n_gen)
    with plain_versions():
        lp = teacher_forced(svc, ids, imgs, mask, toks, n_gen)
    rows = live.nonzero()[:, 0]
    lk, lp = lk[:, rows], lp[:, rows]
    rel = ((lk - lp).flatten(1).norm(dim=1)
           / lp.flatten(1).norm(dim=1)).tolist()
    if not max(rel) <= LOGIT_REL_TOL:
        raise AssertionError(f"teacher-forced logits: rel err {max(rel)} > "
                             f"{LOGIT_REL_TOL}")
    # the kernel run's own teacher-forced argmax reproduces its tokens
    if not torch.equal(lk[0].argmax(-1).int(), toks[rows, 0]):
        raise AssertionError("teacher-forced kernel run disagrees with "
                             "the generate call's first token")
    top1 = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    return {"rows": len(rows), "steps": n_gen, "prefill_rel_err": rel[0],
            "decode_rel_err_max": max(rel[1:], default=0.0),
            "top1_agreement": top1,
            "tokens": toks[rows, :n_gen].tolist()}, (ids, imgs, mask, live)


def run_serve():
    torch.cuda.reset_peak_memory_stats()
    cfg = vllm_7b_chat_config(llm=LLMConfig(vocab_size=32096, quant="int4"))
    t = time.perf_counter()
    core = build_core(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    n_int4 = sum(isinstance(m, Q.Int4Linear) for m in core.modules())
    per_fwd_int4 = 7 * cfg.llm.num_layers + 1
    if n_int4 != per_fwd_int4:
        raise AssertionError(f"{n_int4} Int4Linear modules, want "
                             f"{per_fwd_int4}")
    per_call_flash = cfg.vis_encoder.num_layers + cfg.llm.num_layers
    svc = ChatService(cfg, core, SimpleTokenizer(),
                      image_size=cfg.vis_encoder.image_size,
                      max_batch=SERVE_BATCH, max_prompt=SERVE_PROMPT,
                      max_new_tokens=SERVE_NEW,
                      batch_window_ms=BATCH_WINDOW_MS, device="cuda")
    image_reqs, text_req = serve_requests()
    for r in image_reqs + [text_req]:
        n = len(svc._encode(r["prompt"], r.get("image"), r.get("history"))[0])
        if n >= SERVE_PROMPT:
            raise AssertionError(f"prompt of {n} tokens would be cut")
    srv = make_server(svc, host="127.0.0.1", port=0)
    http = threading.Thread(target=srv.serve_forever, daemon=True)
    http.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"

    calls = []

    def call(label, fn):
        f0, q0 = A.flash_attention.launches, Q.int4_matmul.launches
        b0, s0 = svc.stats["batches_total"], svc.stats["steps_total"]
        t0 = time.perf_counter()
        res = fn()
        calls.append({"call": label,
                      "wall_ms": (time.perf_counter() - t0) * 1e3,
                      "generate_calls": svc.stats["batches_total"] - b0,
                      "num_generated": svc.stats["steps_total"] - s0,
                      "flash": A.flash_attention.launches - f0,
                      "int4": Q.int4_matmul.launches - q0})
        return res

    def concurrent():
        res = [None] * len(image_reqs)

        def fire(i):
            res[i] = svc.generate(**image_reqs[i])
        threads = [threading.Thread(target=fire, args=(i,))
                   for i in range(len(image_reqs))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=900)
        return res

    img0 = image_reqs[0]
    body = {"prompt": img0["prompt"],
            "image_b64": base64.b64encode(img0["image"].tobytes()).decode(),
            "image_shape": list(img0["image"].shape)}
    # the main path, with the launch counts taken around it alone
    A.flash_attention.launches = 0
    Q.int4_matmul.launches = 0
    with torch.no_grad():
        batched = call("4 image requests from threads", concurrent)
        alone = call("image request 0 alone", lambda: svc.generate(**img0))
        text = call("text-only with history",
                    lambda: svc.generate(**text_req))
        over_http = call("image request 0 over HTTP",
                         lambda: post_json(url + "/v1/generate", body))
    torch.cuda.synchronize()
    launches = {"flash_attn_fwd": A.flash_attention.launches,
                "int4_matmul": Q.int4_matmul.launches}
    srv.shutdown()
    srv.server_close()

    answers = batched + [alone, text, over_http]
    vocab = cfg.llm.vocab_size
    for a in answers:
        if a is None or a["num_tokens"] < 1 or \
                not all(0 <= t < vocab for t in a["ids"]):
            raise AssertionError(f"bad answer {a}")
    if alone["ids"] != over_http["ids"]:
        raise AssertionError("the same request twice gave other ids")
    if calls[0]["generate_calls"] != 1:
        raise AssertionError(f"4 threaded requests took "
                             f"{calls[0]['generate_calls']} generate calls")
    for c in calls:
        want = (per_call_flash * c["generate_calls"],
                per_fwd_int4 * c["num_generated"])
        if (c["flash"], c["int4"]) != want or c["generate_calls"] < 1:
            raise AssertionError(f"launches {c} != (flash, int4) {want}")

    with torch.no_grad():
        enc = [_Request(*svc._encode(r["prompt"], r.get("image"),
                                     r.get("history"))[:2])
               for r in image_reqs]
        cmp_images, packed = compare_plain(svc, enc)
        tr = _Request(*svc._encode(text_req["prompt"], None,
                                   text_req["history"])[:2])
        cmp_text, _ = compare_plain(svc, [tr])
        direct_equals_alone = \
            cmp_images["tokens"][0][:alone["num_tokens"]] == alone["ids"]
        ids, imgs, mask, live = packed
        ttft = host_ms(lambda: svc.core(
            ids, imgs, svc.tid, attn_mask=mask,
            cache=KVCache.create(cfg.llm, SERVE_BATCH, SERVE_PROMPT
                                 + SERVE_NEW + 8, torch.bfloat16, "cuda")),
            n=3)
        out = svc.generate_fn(ids, imgs, attn_mask=mask, live=live)
        n_gen = int(out["num_generated"])
        step_ms = []
        teacher_forced(svc, ids, imgs, mask, out["out_tokens"], n_gen,
                       step_ms)
        gen_ms = host_ms(lambda: svc.generate_fn(ids, imgs, attn_mask=mask,
                                                 live=live), n=3)
    emit({"phase": "serve", "config": "vllm_7b_chat_config quant=int4",
          "int4_linear_modules": n_int4, "build_core_s": build_s,
          "max_batch": SERVE_BATCH, "max_prompt": SERVE_PROMPT,
          "max_new_tokens": SERVE_NEW, "calls": calls, "launches": launches,
          "answers": [{"num_tokens": a["num_tokens"], "text": a["text"][:60]}
                      for a in answers],
          "batched_equals_alone": batched[0]["ids"] == alone["ids"],
          "direct_call_equals_alone": direct_equals_alone,
          "plain_images": {k: v for k, v in cmp_images.items()
                           if k != "tokens"},
          "plain_text": {k: v for k, v in cmp_text.items() if k != "tokens"},
          "logit_rel_tol": LOGIT_REL_TOL,
          "ttft_ms": ttft, "decode_step_ms_median": statistics.median(step_ms),
          "decode_steps_timed": len(step_ms),
          "generate_ms": gen_ms, "generate_tokens": SERVE_BATCH * n_gen,
          "tok_per_s": SERVE_BATCH * n_gen / (gen_ms / 1e3),
          "metrics": svc.metrics(),
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9})
    profile_decode_step(svc, packed)
    svc.close()
    return launches


def profile_decode_step(svc, packed):
    """One warm decode step (llm_step + the tool state machine) of the
    packed batch under torch.profiler."""
    ids, imgs, mask, live = packed
    cfg, core, tid = svc.cfg, svc.core, svc.tid
    B, L = ids.shape
    max_len = SERVE_PROMPT + SERVE_NEW + 8
    with torch.no_grad():
        cache = KVCache.create(cfg.llm, B, max_len, torch.bfloat16, "cuda")
        out = core(ids, imgs, tid, attn_mask=mask, cache=cache)
        tok = out["logits"][:, -1].argmax(-1).int()
        embed = core.embed_tokens(tok[:, None].long())
        dmask = torch.cat([mask, torch.ones(B, max_len - L, dtype=torch.bool,
                                            device="cuda")], 1)
        zero = torch.zeros_like(tok)

        def step():
            pos = torch.full((B, 1), cache.index, dtype=torch.long,
                             device="cuda")
            res = core.llm_step(embed, pos, cache, dmask)
            sampled = res["logits"][:, -1].argmax(-1).int()
            advance_tool_state(core, tid, cfg.num_embs, cfg.num_embs_gen,
                               sampled, zero, zero)
            return bool((sampled == svc.eos_id).all())

        step()                                  # warm
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t) * 1e3
    emit({"phase": "serve_profile", **device_summary(prof, wall_ms)})


def kernel_entry(name, source, replaces, launches, cases, main_case):
    main = next(c for c in cases if c["case"] == main_case)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "main_case": main_case,
            **{k: main[k] for k in ("device_ms", "kernels_per_call",
                                    "library_device_ms",
                                    "library_kernels_per_call",
                                    "composite_ms", "composite_device_ms")
               if k in main},
            "cases": cases}


# the kernel phase's checks by name, for `--kernels`
KERNEL_CHECKS = {"flash_fwd": check_attention,
                 "flash_bwd": check_attention_bwd,
                 "msda_fwd": check_msda, "msda_bwd": check_msda_bwd,
                 "int4": check_int4, "gathers": lambda g: check_gathers()}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--kernels", help="comma-separated kernel checks to run alone, of "
        f"{', '.join(KERNEL_CHECKS)}: the device and build phases, those "
        "checks, the nvidia-smi line, and no model phase and no ok line")
    args = parser.parse_args(argv)
    only = args.kernels.split(",") if args.kernels else []
    unknown = set(only) - set(KERNEL_CHECKS)
    if unknown:
        parser.error(f"unknown kernel checks {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    t = time.perf_counter()
    build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "kernels": list(build.KERNELS),
          "ptxas": {k: [ln.strip() for ln in v.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Function properties" in ln]
                    for k, v in build.build_log.items()}})

    g = torch.Generator(device="cuda").manual_seed(0)
    if only:
        for name in only:
            KERNEL_CHECKS[name](g)
        print(smi, flush=True)
        return 0
    attn_cases = check_attention(g)
    attn_bwd_cases = check_attention_bwd(g)
    msda_cases = check_msda(g)
    msda_bwd_cases = check_msda_bwd(g)
    int4_cases = check_int4(g)
    lane_cases, row_cases = check_gathers()
    det = run_slice()
    gc.collect()
    torch.cuda.empty_cache()
    chat = run_serve()
    gc.collect()
    torch.cuda.empty_cache()
    train = run_train()
    gc.collect()
    torch.cuda.empty_cache()
    probe = run_probes()
    # each path's counts were read around that path's run alone
    by_path = {"det": det, "train": train, "probes": probe, "chat": chat}

    def launches(name):
        per = {p: c[name] for p, c in by_path.items() if name in c}
        if not all(per.values()):
            raise AssertionError(f"{name}: no launch on a path: {per}")
        return sum(per.values()), per

    entries = []
    for name, src, replaces, cases, main_case in (
            ("flash_attn_fwd", "visionllm_tpu_torch/csrc/flash_attn_fwd.cu",
             "visionllm_tpu/ops/attention.py:72", attn_cases,
             "llama7b_prefill"),
            ("ms_deform_attn_fwd",
             "visionllm_tpu_torch/csrc/ms_deform_attn_fwd.cu",
             "visionllm_tpu/ops/ms_deform_attn.py:212", msda_cases,
             "captured_det_encoder"),
            ("int4_matmul", "visionllm_tpu_torch/csrc/int4_matmul.cu",
             "visionllm_tpu/ops/quant4.py:112", int4_cases,
             "decode_m4_4096x11008"),
            ("flash_attn_bwd", "visionllm_tpu_torch/csrc/flash_attn_bwd.cu",
             "jax/experimental/pallas/ops/tpu/flash_attention.py:1121 "
             "(_flash_attention_bwd_dkv) and :1456 (_flash_attention_bwd_dq), "
             "reached from visionllm_tpu/ops/attention.py:125",
             attn_bwd_cases, "llama7b_prefill"),
            ("ms_deform_attn_bwd",
             "visionllm_tpu_torch/csrc/ms_deform_attn_bwd.cu",
             "visionllm_tpu/ops/ms_deform_attn.py:212 (the gradient of "
             "_msda_kernel's op, autodiff of :99 and :314)", msda_bwd_cases,
             "captured_train_encoder"),
            ("lane_gather", "visionllm_tpu_torch/csrc/gather_probes.cu",
             "tools/msda_kernel_attempts.py:34", lane_cases, "extent_256"),
            ("row_gather", "visionllm_tpu_torch/csrc/gather_probes.cu",
             "tools/msda_kernel_attempts.py:59", row_cases,
             "n131072_rpb64")):
        total, per = launches(name)
        entry = kernel_entry(name, src, replaces, total, cases, main_case)
        entry["launches_by_path"] = per
        entries.append(entry)
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
