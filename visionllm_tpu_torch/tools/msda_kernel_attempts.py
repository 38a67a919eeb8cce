"""The gather probes of the MSDA kernel study, on an NVIDIA GPU: the
counterpart of the JAX tool `tools/msda_kernel_attempts.py`.

  A. `attempt_a`: the lane gather `take_along_axis(v, idx, axis=1)` of an
     f32 [8, extent] block with reversed indices. Mosaic rejects extents
     beyond one 128-lane vreg; the port's kernel spreads each row over a
     thread-block cluster's shared memory, so the probe also runs an
     extent near the kernel's limit (`gather.MAX_LANE_EXTENT`).
  B. `attempt_b(rpb, n)`: the row gather `table[idx]` of a bf16
     [16384, 128] table (256-byte quad rows of the MSDA quad layout) at
     `rpb` rows per block: checked against the plain version and timed in
     rows per second.
  C. `baseline(n)`: `torch.index_select` of the same rows, the library
     yardstick (used nowhere in the port).

Run on a card:  python -m visionllm_tpu_torch.tools.msda_kernel_attempts
Each probe prints a line and returns its numbers; `main` returns them all.
Tables and indices are made with numpy from seed 0.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from visionllm_tpu_torch.device import resolve_device
from visionllm_tpu_torch.ops import gather

S = 16384          # source rows (about one 800 px level)
N = 131072         # gathered rows
DQ = 128           # quad-row width (4 D at D = 32), bf16
LANE_EXTENTS = (128, 256, 57344)   # the probe's two, and 224 KB of f32


def _ms(fn, device, n=20, warmup=3) -> Optional[float]:
    """Mean device ms of fn over n calls (CUDA events); None on the CPU."""
    if device.type != "cuda":
        return None
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / n


def lane_inputs(extent: int, device) -> tuple:
    v = torch.arange(8 * extent, dtype=torch.float32,
                     device=device).reshape(8, extent)
    idx = torch.arange(extent - 1, -1, -1, dtype=torch.int32,
                       device=device).expand(8, extent).contiguous()
    return v, idx


def row_inputs(n: int, device) -> tuple:
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.standard_normal((S, DQ)).astype(np.float32)
                             ).to(device).to(torch.bfloat16)
    idx = torch.from_numpy(rng.integers(0, S, n).astype(np.int32)).to(device)
    return table, idx


def attempt_a(device=None, extents=LANE_EXTENTS) -> List[Dict]:
    """Lane gather at each extent: correctness against the reversed rows
    and the kernel's ms."""
    dev = resolve_device(device)
    res = []
    for extent in extents:
        v, idx = lane_inputs(extent, dev)
        out = gather.lane_gather(v, idx)
        ok = bool(torch.equal(out, v.flip(1)))
        ms = _ms(lambda: gather.lane_gather(v, idx), dev)
        print(f"A: extent={extent}: ran, correct={ok}, ms={ms}", flush=True)
        res.append({"probe": "A", "extent": extent, "correct": ok, "ms": ms})
    return res


def attempt_b(rpb: int, n: int = N, device=None) -> Dict:
    """Row gather at `rpb` rows per block: correctness against
    `table[idx]`, ms and rows per second."""
    dev = resolve_device(device)
    table, idx = row_inputs(n, dev)
    out = gather.row_gather(table, idx, rpb)
    ok = bool(torch.equal(out, table[idx.long()]))
    ms = _ms(lambda: gather.row_gather(table, idx, rpb), dev)
    rate = None if ms is None else n / (ms * 1e-3)
    print(f"B: rpb={rpb} n={n}: correct={ok}, ms={ms}, rows/s={rate}",
          flush=True)
    return {"probe": "B", "rpb": rpb, "n": n, "correct": ok, "ms": ms,
            "rows_per_s": rate}


def baseline(n: int = N, device=None) -> Dict:
    """`torch.index_select` of the same rows (the library yardstick)."""
    dev = resolve_device(device)
    table, idx = row_inputs(n, dev)
    ms = _ms(lambda: torch.index_select(table, 0, idx), dev)
    rate = None if ms is None else n / (ms * 1e-3)
    print(f"C: torch.index_select n={n}: ms={ms}, rows/s={rate}", flush=True)
    return {"probe": "C", "n": n, "ms": ms, "rows_per_s": rate}


def main(device=None) -> Dict:
    dev = resolve_device(device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    out = {"device": name, "A": attempt_a(dev), "B": [], "C": []}
    for n in (8192, N):
        for rpb in (8, 64):
            out["B"].append(attempt_b(rpb, n, dev))
        out["C"].append(baseline(n, dev))
    return out


if __name__ == "__main__":
    print(json.dumps(main()))
    sys.exit(0)
