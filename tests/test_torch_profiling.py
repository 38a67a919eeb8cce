"""The port's profiling harness (`visionllm_tpu_torch/utils/profiling.py`)
on the CPU: `fit_device_time`'s chained calls and slope, `TimeCounter`
against the JAX package's, `trace` writing a Chrome trace, and
`debug_nans` naming the module that made a NaN and restoring the state
it changed."""

import glob
import json
import math

import pytest
import torch
import torch.nn as nn

from visionllm_tpu.utils import profiling as JP
from visionllm_tpu_torch.utils import profiling as P


def test_fit_device_time_chains_n_lo_and_n_hi_calls():
    """Each timed run chains its calls through the carry (sum(out) *
    1e-12, fp32 on the argument's device); a warm-up and one more run of
    n_lo, then `repeats` runs of n_lo and of n_hi."""
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    carries = []

    def fn(a, carry):
        assert carry.dtype == torch.float32 and carry.dim() == 0
        assert carry.device == a.device
        carries.append(float(carry))
        return a * 2.0 + carry

    t = P.fit_device_time(fn, x, n_lo=2, n_hi=5, repeats=3)
    assert math.isfinite(t) and t > 0
    assert len(carries) == 2 + 2 + 3 * (2 + 5)
    # every run starts from carry 0 and chains: c1 = sum(2x) * 1e-12
    assert carries[:2] == [0.0, pytest.approx(30.0 * 1e-12, rel=1e-6)]


def test_fit_device_time_is_the_slope():
    """A call that sleeps 4 ms costs about 4 ms a call, whatever the
    fixed cost of a run."""
    import time

    def fn(a, carry):
        time.sleep(0.004)
        return a + carry

    t = P.fit_device_time(fn, torch.ones(3), n_lo=2, n_hi=8, repeats=2)
    assert 0.002 < t < 0.05


def test_time_counter_summary_has_jax_shape():
    got, want = P.TimeCounter(), JP.TimeCounter()
    for c in (got, want):
        for name in ("a", "b", "a"):
            with c.span(name):
                pass
    g, w = got.summary(), want.summary()
    assert list(g) == list(w) == ["a", "b"]
    for k in g:
        assert set(g[k]) == set(w[k]) == {"total_s", "mean_s", "count"}
        assert g[k]["count"] == w[k]["count"]
        assert g[k]["mean_s"] == pytest.approx(g[k]["total_s"] /
                                               g[k]["count"])


def test_trace_writes_a_chrome_trace(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        with torch.profiler.record_function("port_span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "port_span" for e in events)
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.events() is not None


class _Net(nn.Module):
    def __init__(self):
        super().__init__()
        self.body = nn.Sequential(nn.Linear(4, 4), nn.Linear(4, 4))
        self.head = nn.Linear(4, 2)

    def forward(self, x):
        return self.head(torch.log(self.body(x)))


def _hooks(net):
    return sum(len(m._forward_hooks) for m in net.modules())


def test_debug_nans_names_the_module_and_restores_the_state():
    torch.manual_seed(0)
    net = _Net()
    x = torch.randn(8, 4)
    anomaly = torch.is_anomaly_enabled()
    # log of a negative feature makes the NaN in `head`'s input, so the
    # first module whose output holds it is `head`
    with pytest.raises(FloatingPointError, match=r"debug_nans: head "
                       r"\(Linear\)"):
        with P.debug_nans(net):
            assert torch.is_anomaly_enabled()
            assert _hooks(net) == 5
            net(x)
    assert _hooks(net) == 0
    assert torch.is_anomaly_enabled() == anomaly
    # a finite run does not raise; a NaN in the input shows at the first
    # module, by its path
    with P.debug_nans(net):
        out = net.body(x)
    assert torch.isfinite(out).all()
    with pytest.raises(FloatingPointError, match=r"body\.0 \(Linear\)"):
        with P.debug_nans(net):
            net(torch.full((2, 4), float("nan")))
    with P.debug_nans(net, enable=False):
        assert not torch.is_anomaly_enabled()
        assert _hooks(net) == 0
        net(x)
    assert _hooks(net) == 0


def test_debug_nans_checks_the_backward():
    """Anomaly mode: a backward that makes a NaN (0 / 0 in sqrt's
    gradient at 0) raises naming its function."""
    w = torch.tensor([0.0, 1.0], requires_grad=True)
    with P.debug_nans(nn.Identity()):
        loss = (torch.sqrt(w) * torch.tensor([0.0, 1.0])).sum()
        assert torch.isfinite(loss)
        with pytest.raises(RuntimeError, match="SqrtBackward"):
            loss.backward()
