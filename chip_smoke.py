#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device  - requires a CUDA card (exits 2 without one) and prints
             `nvidia-smi --query-gpu=name,power.limit` for it;
2. build   - builds every CUDA kernel of the det path from
             `visionllm_tpu_torch/csrc/` (one nvcc per source, in
             parallel) and reports the seconds;
3. kernel  - holds each kernel against its plain PyTorch version at the
             main-path shapes, on the card, with the tolerance below, and
             times the kernel, the plain version and one PyTorch library
             call computing the same function (yardstick only; the port
             never calls it);
4. slice   - builds `VisionLLMWithTools` at full width (CLIP-L/336 24
             layers, LLaMA-7B 32 layers, Grounding-DINO with Swin-T at
             512 px) in bf16 with seeded random weights, answers 3 det
             requests through `infer_det`, checks shapes, finiteness and
             the launch counters (flash 56 and MSDA 12 per request), holds
             the text queries and the top-900 selection against the same
             model run with the plain versions, and times a request and
             its stages;
5. profile - one more request under torch.profiler: device kernel time,
             the device's idle share, and the kernels that take the most.

Then it prints the `{"kernels": [...]}` line, the card's name and power
limit, and as its last line `{"ok": true, "device": {...}}`. Any failed
check raises, so the script exits nonzero and prints no ok line.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from visionllm_tpu_torch.config import vllm_7b_det_config
from visionllm_tpu_torch.kernels import build
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.ops import attention as A
from visionllm_tpu_torch.ops import ms_deform_attn as M

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_TENSOR_FLOPS = 989e12    # H100 SXM dense bf16 tensor cores
FP32_FLOPS = 67e12            # H100 SXM fp32 outside the tensor cores
DET_SIZE = 512
N_REQUESTS = 3
N_TIMED = 5
# kernel vs plain on the card, bf16 outputs: max |kernel - plain| must
# stay within ATOL + RTOL * max |plain| (a few bf16 ulps; the plain
# attention also rounds its probabilities to bf16 before P V)
ATOL, RTOL = 2e-2, 1e-2
# text queries after 32 bf16 LLaMA layers, kernel run vs plain run:
# relative Frobenius error
TQ_REL_TOL = 5e-2


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

def attention_cases(g):
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


def check_attention(g):
    cases = []
    for name, q, k, v, causal, seg in attention_cases(g):
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

        def lib():
            if mask is None:
                return F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=causal, enable_gqa=Hkv != H)
            return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask)

        lib_out = lib().transpose(1, 2)
        torch.cuda.synchronize()
        check_close(f"sdpa[{name}]", lib_out, want)
        pairs = sum(attention_pairs(L, causal, seg)) * H
        flops = 4 * pairs * D
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + got.numel()) + \
            (0 if seg is None else seg.numel() * 4)
        b_ms, b_by = bound(nbytes, flops, BF16_TENSOR_FLOPS)
        case = {
            "case": name, "shape": [B, L, H, Hkv, D], "causal": causal,
            "segment_ids": seg is not None, "max_abs_err": err,
            "ms": cuda_ms(lambda: A.flash_attention(
                q, k, v, causal=causal, segment_ids=seg)),
            "plain_ms": cuda_ms(lambda: A.flash_attention_plain(
                q, k, v, causal=causal, segment_ids=seg)),
            "library_ms": cuda_ms(lib), "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        emit({"phase": "kernel", "kernel": "flash_attn_fwd", **case})
        cases.append(case)
    return cases


def msda_inputs(g, Q=None):
    """Inputs at the 512 px det shapes; Q=None gives the encoder's Q = S."""
    shapes = tuple((DET_SIZE // s, DET_SIZE // s) for s in (8, 16, 32, 64))
    S = sum(h * w for h, w in shapes)
    Q = S if Q is None else Q
    value = torch.randn(1, S, 8, 32, generator=g, device="cuda").to(
        torch.bfloat16)
    # locations partly outside [0, 1] to exercise the zero padding
    loc = torch.rand(1, Q, 8, 4, 4, 2, generator=g, device="cuda") * 1.4 - 0.2
    attw = torch.softmax(torch.randn(1, Q, 8, 16, generator=g, device="cuda"),
                         -1).reshape(1, Q, 8, 4, 4)
    return value, shapes, loc, attw


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


def check_msda(g):
    cases = []
    for name, Q in (("encoder", None), ("decoder", 900)):
        value, shapes, loc, attw = msda_inputs(g, Q)
        got = M.ms_deform_attn(value, shapes, loc, attw)
        want = M.ms_deform_attn_plain(value, shapes, loc, attw)
        torch.cuda.synchronize()
        err = check_close(f"ms_deform_attn[{name}]", got, want)
        D = value.shape[3]
        n_loc = attw.numel()
        flops = 2 * D * msda_valid_corners(shapes, loc) + 20 * n_loc
        nbytes = (2 * value.numel() + 4 * loc.numel() + 4 * attw.numel()
                  + 2 * got.numel())
        b_ms, b_by = bound(nbytes, flops, FP32_FLOPS)
        case = {
            "case": name, "shape": {"S": value.shape[1], "Q": loc.shape[1],
                                    "H": 8, "D": D, "L": 4, "P": 4},
            "max_abs_err": err,
            "ms": cuda_ms(lambda: M.ms_deform_attn(value, shapes, loc, attw)),
            "plain_ms": cuda_ms(lambda: M.ms_deform_attn_plain(
                value, shapes, loc, attw), n=5),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "flops": flops, "bytes": nbytes}
        emit({"phase": "kernel", "kernel": "ms_deform_attn_fwd", **case})
        cases.append(case)
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
        embeds = model.core.build_prompt_embeds(ids, images, tid)
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
    """One warm request under torch.profiler: wall ms, the summed device
    kernel time (one stream, so their union), the device's idle share,
    and the kernels that take the most device time."""
    ids, images, aug = req
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.infer_det(ids, images, aug, tid)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.device_time_total / 1e3, n + 1)
    busy_ms = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]
    emit({"phase": "profile", "wall_ms": wall_ms, "device_busy_ms": busy_ms,
          "device_idle_share": 1.0 - busy_ms / wall_ms,
          "device_kernels": sum(n for _, n in by_name.values()),
          "top_kernels": [{"name": k[:90], "ms": t, "count": n}
                          for k, (t, n) in top]})


def kernel_entry(name, source, replaces, launches, cases, main_case):
    main = next(c for c in cases if c["case"] == main_case)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "main_case": main_case,
            "cases": cases}


def main() -> int:
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
                        if "registers" in ln or "spill" in ln]
                    for k, v in build.build_log.items()}})

    g = torch.Generator(device="cuda").manual_seed(0)
    attn_cases = check_attention(g)
    msda_cases = check_msda(g)
    launches = run_slice()

    emit({"kernels": [
        kernel_entry("flash_attn_fwd",
                     "visionllm_tpu_torch/csrc/flash_attn_fwd.cu",
                     "visionllm_tpu/ops/attention.py:72",
                     launches["flash_attn_fwd"], attn_cases,
                     "llama7b_prefill"),
        kernel_entry("ms_deform_attn_fwd",
                     "visionllm_tpu_torch/csrc/ms_deform_attn_fwd.cu",
                     "visionllm_tpu/ops/ms_deform_attn.py:212",
                     launches["ms_deform_attn_fwd"], msda_cases, "encoder"),
    ]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
