"""Tracing, timing and NaN checks (counterpart of
`visionllm_tpu/utils/profiling.py`).

* `trace(log_dir)`: a `torch.profiler` trace (CPU, and CUDA where there
  is a card) written under `log_dir` as a Chrome trace that TensorBoard
  and Perfetto read.
* `debug_nans(model, enable)`: a scoped check that raises on the first
  of `model`'s modules whose floating output is not finite, naming it
  (forward hooks), with autograd's anomaly mode on for the backward.
* `fit_device_time(fn, *args)`: per-call time of `fn` as the slope
  between two counts of chained back-to-back calls, which fits out the
  fixed cost of starting and ending a timed run (CUDA events on a card,
  the host clock on the CPU).
* `TimeCounter`: named wall-clock spans, the JAX package's unchanged.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterator, Optional

import torch
import torch.nn as nn
from torch.profiler import (ProfilerActivity, profile,
                            tensorboard_trace_handler)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[profile]:
    """Profile the block with `torch.profiler` (CPU activity, and CUDA's
    when a card is present) and write its Chrome trace,
    `<host>.<pid>.<ns>.pt.trace.json`, under `log_dir` when the block
    ends. Yields the profiler, whose events the caller may read."""
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _first_non_finite(out) -> Optional[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return out if (out.is_floating_point()
                       and not torch.isfinite(out).all()) else None
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for x in out:
            bad = _first_non_finite(x)
            if bad is not None:
                return bad
    return None


@contextlib.contextmanager
def debug_nans(model: nn.Module, enable: bool = True) -> Iterator[None]:
    """Scoped NaN checking of `model`. With `enable`, each of its
    modules' forward outputs (tensors, and tensors in tuples, lists and
    dicts) is checked as the module returns, and the first that holds a
    NaN or an infinity raises `FloatingPointError` naming the module by
    its path in `model` (the innermost module that made it: hooks run as
    modules return). Autograd's anomaly mode is on (or, with `enable`
    False, off) inside the block, so a backward that makes a NaN raises
    naming its function. Each check synchronizes with the device. The
    hooks are removed and the anomaly mode restored on exit."""

    def hook_for(name):
        def hook(module, args, out):
            bad = _first_non_finite(out)
            if bad is not None:
                raise FloatingPointError(
                    f"debug_nans: {name or 'the model'} "
                    f"({type(module).__name__}) returned non-finite values "
                    f"in a {tuple(bad.shape)} {bad.dtype} output")
        return hook

    with torch.autograd.set_detect_anomaly(enable), contextlib.ExitStack() \
            as stack:
        if enable:
            for name, module in model.named_modules():
                stack.callback(module.register_forward_hook(
                    hook_for(name)).remove)
        yield


def fit_device_time(fn: Callable[..., Any], *args, n_lo: int = 4,
                    n_hi: int = 36, repeats: int = 2) -> float:
    """Seconds per `fn(*args, carry)` call, the fixed cost of a timed run
    fitted out. `fn` must accept a trailing float32 carry scalar on the
    device and return a tensor; the calls are chained through
    `carry = sum(out) * 1e-12`, so none can be skipped or reordered. On a
    card CUDA events time each run of back-to-back calls, on the CPU the
    host clock; the slope between the best of `repeats` runs of `n_lo`
    and of `n_hi` calls is the time a call."""
    device = next((a.device for a in args if isinstance(a, torch.Tensor)),
                  torch.device("cpu"))
    cuda = device.type == "cuda"

    def chained(n):
        c = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(n):
            c = fn(*args, c).float().sum() * 1e-12
        return c

    def run(n):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            chained(n)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        chained(n).item()
        return time.perf_counter() - t0

    with torch.no_grad():
        chained(n_lo).item()            # warm up (builds, caches)
        run(n_lo)
        t_lo = min(run(n_lo) for _ in range(repeats))
        t_hi = min(run(n_hi) for _ in range(repeats))
    return max((t_hi - t_lo) / (n_hi - n_lo), 1e-9)


class TimeCounter:
    """Named wall-clock accumulator (reference unipose TimeCounter
    equivalent, host-side)."""

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}

    @contextlib.contextmanager
    def span(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict:
        return {k: {"total_s": v, "mean_s": v / self.counts[k],
                    "count": self.counts[k]}
                for k, v in self.totals.items()}
