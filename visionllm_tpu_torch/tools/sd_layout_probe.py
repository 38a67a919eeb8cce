"""Which memory format the SD-1.5 maps take on a card: one [EDIT] UNet
pass at full width (B 3, the three-way guidance batch; 64² latents,
in_channels 8, a 77 x 768 context) and one VAE decode at 512² (B 1),
both bf16 with the fp32 norms of `build_model`, in NCHW contiguous and
in channels_last.

For each layout, in the order contiguous, channels_last, channels_last,
contiguous (so that drift shows), the probe sets `unet.MAP_FORMAT` and
the modules' weights to it, warms up, and reads for each module
  * `device_ms`: the summed device time of one call's kernels
    (torch.profiler, the mean of PROFILED calls);
  * `event_ms`: one call between two CUDA events, the median of TIMED
    calls (the device's clock, the gaps the host leaves included);
  * the call's kernel count and its top kernels.
`unet.MAP_FORMAT` is the layout with the smaller device time for an
image (50 UNet passes and one decode); this probe is how that was
decided, and how to decide it again.

Run on a card:  python -m visionllm_tpu_torch.tools.sd_layout_probe
It prints one JSON line a module and run, then one with each layout's
medians and the card's name and power limit. Weights are seeded random
(`init_weights`, seed 0), inputs from torch seed 0.
"""

from __future__ import annotations

import json
import statistics
import subprocess
from typing import Callable, Dict

import torch
import torch.nn as nn
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.models.common import init_weights
from visionllm_tpu_torch.models.stable_diffusion import unet as SDU
from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
    unet_cfg_for, vae_cfg_for)
from visionllm_tpu_torch.models.stable_diffusion.vae import AutoencoderKL

B, IN_CHANNELS, CTX_LEN, CTX_DIM = 3, 8, 77, 768
WARMUP, TIMED, PROFILED = 3, 5, 3
LAYOUTS = {"contiguous": torch.contiguous_format,
           "channels_last": torch.channels_last}
ORDER = ("contiguous", "channels_last", "channels_last", "contiguous")


def build(make: Callable[[], nn.Module], dev: torch.device) -> nn.Module:
    """A module as `build_model` makes it: bf16, its norms fp32, seeded
    random weights."""
    with torch.device("meta"):
        mod = make().to(dtype=torch.bfloat16)
    for m in mod.modules():
        if isinstance(m, (SDU.GroupNorm32, SDU.LayerNorm)):
            m.float()
    mod = mod.to_empty(device=dev)
    init_weights(mod, torch.Generator(device=dev).manual_seed(0))
    return mod.eval()


def time_call(fn: Callable[[], torch.Tensor]) -> Dict:
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    event_ms = []
    for _ in range(TIMED):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        event_ms.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    by_name: Dict[str, list] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            tot = by_name.setdefault(e.name, [0.0, 0])
            tot[0] += e.device_time_total / 1e3
            tot[1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    return {"device_ms": sum(t for t, _ in by_name.values()) / PROFILED,
            "event_ms": statistics.median(event_ms),
            "event_ms_runs": event_ms,
            "kernels_a_call": sum(n for _, n in by_name.values()) / PROFILED,
            "top_kernels": [{"name": k[:90], "ms_a_call": t / PROFILED,
                             "count_a_call": n / PROFILED}
                            for k, (t, n) in top]}


def main() -> Dict:
    dev = resolve_device(None)
    unet = build(lambda: SDU.UNet2DCondition(
        unet_cfg_for(64, IN_CHANNELS, CTX_DIM)), dev)
    vae = build(lambda: AutoencoderKL(vae_cfg_for(64)), dev)
    torch.manual_seed(0)
    x = torch.randn(B, 64, 64, IN_CHANNELS, device=dev, dtype=torch.bfloat16)
    t = torch.full((B,), 501, dtype=torch.int32, device=dev)
    ctx = torch.randn(B, CTX_LEN, CTX_DIM, device=dev)
    z = torch.randn(1, 64, 64, 4, device=dev, dtype=torch.bfloat16)
    calls = {"unet_b3": (unet, lambda: unet(x, t, ctx)),
             "vae_decode": (vae, lambda: vae.decode(z))}
    own = SDU.MAP_FORMAT
    runs = []
    try:
        with torch.no_grad():
            for layout in ORDER:
                SDU.MAP_FORMAT = LAYOUTS[layout]
                for name, (mod, fn) in calls.items():
                    mod.to(memory_format=LAYOUTS[layout])
                    runs.append({"layout": layout, "call": name,
                                 **time_call(fn)})
                    print(json.dumps(runs[-1]), flush=True)
    finally:
        SDU.MAP_FORMAT = own
    summary = {f"{name} {layout}": {
        k: statistics.median(r[k] for r in runs
                             if r["layout"] == layout and r["call"] == name)
        for k in ("device_ms", "event_ms")}
        for name in calls for layout in LAYOUTS}
    summary["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"summary": summary}), flush=True)
    return summary


if __name__ == "__main__":
    main()
