"""The port's int4 quantization (`visionllm_tpu_torch/ops/quant4.py`)
against the JAX package on the CPU: `pack_int4` byte for byte,
`int4_matmul_plain` against the Pallas kernel in interpret mode (128-wide
outputs) and `int4_matmul_ref` (odd widths) to 1e-5 in fp32, and
`Int4Linear` / `quantize_llm_int4` against a JAX-packed tree.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.ops import quant4 as J
from visionllm_tpu_torch.ops import quant4 as Q

TOL = 1e-5


def _pack_both(w):
    wp, scale = Q.pack_int4(torch.from_numpy(w))
    jwp, js = J.pack_int4(jnp.asarray(w))
    return wp, scale, np.asarray(jwp), np.asarray(js)


@pytest.mark.parametrize("shape", [(256, 96), (3, 512, 64), (64, 200)],
                         ids=lambda s: "x".join(map(str, s)))
def test_pack_int4_is_byte_identical(shape):
    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    w = rng.normal(0, 0.05, shape).astype(np.float32)
    w.reshape(-1)[:7] = 0.0                  # all-zero rows hit the 1e-8 floor
    wp, scale, jwp, js = _pack_both(w)
    assert wp.dtype == torch.int8 and scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(wp.numpy(), jwp)
    np.testing.assert_array_equal(scale.float().numpy(),
                                  js.astype(np.float32))


@pytest.mark.parametrize("M", [1, 5, 20])
@pytest.mark.parametrize("K,N", [(512, 256), (256, 97)])
def test_plain_matmul_matches_jax(M, K, N):
    rng = np.random.default_rng(M * K + N)
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    wp, scale, jwp, js = _pack_both(w)
    got = Q.int4_matmul_plain(torch.from_numpy(x), wp, scale).numpy()
    if N % 128 == 0:
        want = J.int4_matmul(jnp.asarray(x), jnp.asarray(jwp),
                             jnp.asarray(js), interpret=True)
    else:
        want = J.int4_matmul_ref(jnp.asarray(x), jnp.asarray(jwp),
                                 jnp.asarray(js))
    np.testing.assert_allclose(got, np.asarray(want), atol=TOL, rtol=TOL)


def test_int4_linear_loads_a_jax_packed_tree():
    """A JAX `Int4Dense` tree loads into `Int4Linear` byte for byte and
    both compute the same product; `quantize_llm_int4` packs a Linear to
    the same bytes."""
    from visionllm_tpu_torch.utils.convert import load_jax_params
    rng = np.random.default_rng(7)
    K, N = 256, 130
    w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    x = rng.normal(0, 1, (2, 3, K)).astype(np.float32)
    jwp, js = J.pack_int4(jnp.asarray(w))
    jm = J.Int4Dense(N, dtype=jnp.float32)
    want = jm.apply({"params": {"kernel_p": jwp, "scale": js}},
                    jnp.asarray(x))

    lin = Q.Int4Linear(K, N)
    load_jax_params(lin, jax.tree.map(np.asarray,
                                      {"kernel_p": jwp, "scale": js}))
    np.testing.assert_array_equal(lin.kernel_p.numpy(), np.asarray(jwp))
    np.testing.assert_array_equal(lin.scale.float().numpy(),
                                  np.asarray(js).astype(np.float32))
    got = lin(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=TOL)

    dense = torch.nn.Linear(K, N, bias=False)
    with torch.no_grad():
        dense.weight.copy_(torch.from_numpy(w.T))
    holder = torch.nn.Module()
    holder.q_proj = dense
    Q.quantize_llm_int4(holder)
    assert isinstance(holder.q_proj, Q.Int4Linear)
    np.testing.assert_array_equal(holder.q_proj.kernel_p.numpy(),
                                  np.asarray(jwp))


def test_group_size_matches_jax():
    for cin in (64, 128, 256, 4096, 11008, 96):
        assert Q.group_size(cin) == J.group_size(cin)


def _args(M=2, K=512, N=64, x=None, wp=None, scale=None):
    """CPU tensors of the kernel's argument layout, one of them swapped."""
    g = torch.Generator().manual_seed(M * K + N)
    wp0, s0 = Q.pack_int4(torch.randn(K, N, generator=g) * 0.05)
    x0 = torch.randn(M, K, generator=g).to(torch.bfloat16)
    return (x0 if x is None else x(x0), wp0 if wp is None else wp(wp0),
            s0 if scale is None else scale(s0))


# what the CUDA wrapper refuses before a launch, checked on CPU tensors
BAD_INT4_ARGS = {
    "x_float32": (TypeError, dict(x=lambda t: t.float())),
    "scale_float32": (TypeError, dict(scale=lambda t: t.float())),
    "wp_uint8": (TypeError, dict(wp=lambda t: t.view(torch.uint8))),
    "x_3d": (ValueError, dict(x=lambda t: t[None])),
    "k_mismatch": (ValueError, dict(x=lambda t: t[:, :256])),
    "k_not_multiple_of_2g": (ValueError, dict(      # K 384, G 128
        x=lambda t: t[:, :384], wp=lambda t: t[:192].contiguous(),
        scale=lambda t: t[:3].contiguous())),
    "group_of_8": (ValueError, dict(                # 64 groups of 8 rows
        scale=lambda t: t.repeat_interleave(16, 0))),
    "x_column_strided": (ValueError, dict(
        x=lambda t: t.t().contiguous().t())),
    "x_row_stride_not_8": (ValueError, dict(
        x=lambda t: torch.cat([t, t[:, :4]], 1)[:, :512])),
    "x_misaligned": (ValueError, dict(
        x=lambda t: torch.cat([t[:, :8], t], 1)[:, 4:516])),
    "wp_strided": (ValueError, dict(
        wp=lambda t: torch.cat([t, t], 1)[:, :64])),
}


@pytest.mark.parametrize("case", list(BAD_INT4_ARGS))
def test_check_args_rejects_what_the_kernel_does_not_take(case):
    err, swap = BAD_INT4_ARGS[case]
    x, wp, scale = _args(**swap)
    with pytest.raises(err):
        Q._check_args(x, wp, scale)


def test_check_args_takes_the_kernel_layout():
    x, wp, scale = _args(M=3)
    assert Q._check_args(x, wp, scale) == (3, 512, 64, 128)
    big = torch.zeros(3, 520, dtype=torch.bfloat16)   # row stride 520
    assert Q._check_args(big[:, 8:520], wp, scale) == (3, 512, 64, 128)
