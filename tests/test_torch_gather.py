"""The gather probes on the CPU: the plain versions of `ops/gather.py`
against `jnp.take_along_axis` and `jnp.take` (exact: a gather moves
values), and the probes' entry point run with `device="cpu"`. The kernels
themselves are tested on a card in `tests/test_torch_kernels_gpu.py`."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from visionllm_tpu_torch.ops import gather
from visionllm_tpu_torch.tools import msda_kernel_attempts as probes


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("extent", [128, 256, 1000])
def test_lane_gather_plain_matches_take_along_axis(extent):
    rng = np.random.default_rng(extent)
    v = rng.standard_normal((8, extent)).astype(np.float32)
    idx = rng.integers(0, extent, (8, extent)).astype(np.int32)
    want = np.asarray(jnp.take_along_axis(jnp.asarray(v), jnp.asarray(idx),
                                          axis=1))
    np.testing.assert_array_equal(gather.lane_gather(_t(v), _t(idx)).numpy(),
                                  want)


def test_row_gather_plain_matches_take():
    rng = np.random.default_rng(0)
    table = rng.standard_normal((300, 128)).astype(np.float32)
    idx = rng.integers(0, 300, 1000).astype(np.int32)
    want = np.asarray(jnp.take(jnp.asarray(table, jnp.bfloat16),
                               jnp.asarray(idx), axis=0).astype(jnp.float32))
    got = gather.row_gather(_t(table).bfloat16(), _t(idx), 8).float().numpy()
    np.testing.assert_array_equal(got, want)
    bad = gather.row_gather(_t(table).bfloat16(), torch.tensor([-1, 300]))
    assert torch.count_nonzero(bad) == 0


def test_probe_entry_point_on_cpu():
    a = probes.attempt_a("cpu", extents=(128, 256))
    assert [r["correct"] for r in a] == [True, True]
    b = probes.attempt_b(8, n=512, device="cpu")
    assert b["correct"] and b["ms"] is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probes.baseline()           # the card unless asked for the CPU
