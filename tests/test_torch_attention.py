"""Parity of the port's attention (visionllm_tpu_torch.ops.attention)
against the JAX `multi_head_attention` on the CPU, where JAX takes its
einsum branch and the port its plain versions. fp32, tolerance 1e-5
(same arithmetic, different summation order). The routing cases hold the
port's flash predicate against JAX's on a TPU backend (monkeypatched) and
check the wrapper's argument checks on CPU tensors; the bf16 case holds
the einsum branch to 2 bf16 ulps of the output's scale.

The flash kernel itself is tested on a CUDA card in
`tests/test_torch_kernels_gpu.py`.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from visionllm_tpu.ops.attention import multi_head_attention as jax_mha
from visionllm_tpu_torch.ops import attention as tatt

TOL = 1e-5


def _inputs(seed, B, Lq, Lk, H, H_kv, D):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Lq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Lk, H_kv, D)).astype(np.float32)
    v = rng.standard_normal((B, Lk, H_kv, D)).astype(np.float32)
    return q, k, v


CASES = {
    "noncausal": dict(B=2, Lq=40, Lk=40, H=4, H_kv=4, D=64, causal=False),
    "causal_eq": dict(B=2, Lq=37, Lk=37, H=4, H_kv=4, D=128, causal=True),
    "causal_lq_lt_lk": dict(B=1, Lq=9, Lk=23, H=2, H_kv=2, D=64,
                            causal=True),
    "gqa": dict(B=1, Lq=33, Lk=33, H=8, H_kv=2, D=64, causal=True),
    "odd_lengths": dict(B=1, Lq=13, Lk=29, H=3, H_kv=3, D=16, causal=False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_multi_head_attention_matches_jax(name):
    torch.set_num_threads(1)
    c = dict(CASES[name])
    causal = c.pop("causal")
    q, k, v = _inputs(0, **c)
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal))
    got = tatt.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_segment_ids_match_jax():
    torch.set_num_threads(1)
    q, k, v = _inputs(1, B=2, Lq=30, Lk=30, H=4, H_kv=4, D=64)
    seg = np.ones((2, 30), np.int32)
    seg[0, :7] = 0            # left padding of sample 0
    seg[1, 20:] = 2
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=True, segment_ids=jnp.asarray(seg)))
    got = tatt.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_explicit_mask_takes_einsum_branch():
    torch.set_num_threads(1)
    q, k, v = _inputs(2, B=1, Lq=12, Lk=12, H=2, H_kv=2, D=64)
    rng = np.random.default_rng(3)
    mask = rng.random((1, 1, 12, 12)) > 0.3
    mask[..., 0] = True
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              mask=jnp.asarray(mask)))
    got = tatt.multi_head_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_flash_wrapper_on_cpu_runs_plain_without_launch():
    q, k, v = (torch.from_numpy(a) for a in
               _inputs(4, B=1, Lq=20, Lk=20, H=2, H_kv=2, D=64))
    before = tatt.flash_attention.launches
    out = tatt.flash_attention(q, k, v, causal=True)
    assert tatt.flash_attention.launches == before
    ref = tatt.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(out, ref)


GRAD_CASES = {
    "causal": dict(B=2, L=37, H=4, H_kv=4, D=64, causal=True, seg=False),
    "noncausal": dict(B=1, L=29, H=2, H_kv=2, D=128, causal=False,
                      seg=False),
    "gqa": dict(B=1, L=33, H=8, H_kv=2, D=64, causal=True, seg=False),
    "segments": dict(B=2, L=30, H=4, H_kv=4, D=64, causal=True, seg=True),
}


@pytest.mark.parametrize("name", sorted(GRAD_CASES))
def test_flash_plain_gradients_match_jax_grad(name):
    """dq, dk, dv of the plain flash version (what the backward kernel
    computes, `flash_attention_bwd` on the CPU) against `jax.grad` of the
    JAX `multi_head_attention`; fp32, 1e-5 abs + rel."""
    torch.set_num_threads(1)
    c = GRAD_CASES[name]
    q, k, v = _inputs(5, c["B"], c["L"], c["L"], c["H"], c["H_kv"], c["D"])
    dout = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)
    seg = None
    if c["seg"]:
        seg = np.ones((c["B"], c["L"]), np.int32)
        seg[0, :7] = 0
        seg[1, 20:] = 2

    def f(q_, k_, v_):
        out = jax_mha(q_, k_, v_, causal=c["causal"],
                      segment_ids=None if seg is None else jnp.asarray(seg))
        return jnp.sum(out * dout)
    want = jax.grad(f, argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                          jnp.asarray(v))
    got = tatt.flash_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v)), None,
        torch.from_numpy(dout), None, causal=c["causal"],
        segment_ids=None if seg is None else torch.from_numpy(seg))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)


def test_flash_on_cpu_trains_through_autograd():
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in
               _inputs(7, B=1, Lq=16, Lk=16, H=2, H_kv=2, D=64))
    tatt.multi_head_attention(q, k, v, causal=True).sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


# ---------------------------------------------------------------------------
# flash routing: the port takes the kernel exactly where JAX takes flash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("Lk", [1, 127, 128, 586])
@pytest.mark.parametrize("Lq", [1, 127, 128, 586])
def test_flash_predicate_matches_jax(monkeypatch, Lq, Lk, D, causal, masked):
    """The port's `_flash_ok` against JAX's flash predicate on a TPU
    backend (`mask is None and (_flash_causal_ok if causal else
    _flash_ok)`), by shape. JAX also flashes D 192/256; the port does not
    (no config of the repo has such a head dim), so the grid stops at
    128."""
    from visionllm_tpu.ops import attention as jatt
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    q, k = np.zeros((1, Lq, 1, D)), np.zeros((1, Lk, 1, D))
    want = not masked and (jatt._flash_causal_ok(q, k) if causal
                           else jatt._flash_ok(q, k))
    mask = torch.ones(1, 1, Lq, Lk, dtype=torch.bool) if masked else None
    got = tatt._flash_ok(torch.empty(1, Lq, 1, D), torch.empty(1, Lk, 1, D),
                         mask, causal)
    assert got == want


@pytest.mark.parametrize("causal,D", [(True, 128), (False, 64)],
                         ids=["causal_d128", "noncausal_d64"])
def test_short_bf16_attention_matches_jax(causal, D):
    """L = 100 < 128 takes the einsum branch in both packages, which
    rounds the probabilities to bf16 before P V: bf16 outputs within 2
    bf16 ulps of the output's scale."""
    torch.set_num_threads(1)
    q, k, v = _inputs(8, B=1, Lq=100, Lk=100, H=4, H_kv=2, D=D)
    want = np.asarray(jax_mha(*(jnp.asarray(a, dtype=jnp.bfloat16)
                                for a in (q, k, v)), causal=causal)
                      ).astype(np.float32)
    got = tatt.multi_head_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
        causal=causal)
    assert got.dtype == torch.bfloat16
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (np.floor(np.log2(scale)) - 7)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=2 * ulp)


def _bf16_view(shape, last=None, offset=0):
    """A bf16 [B, L, H, D] view: of a [B, L, H, last] buffer cut to D
    when `last` is given, starting `offset` elements into its storage."""
    B, L, H, D = shape
    row = D if last is None else last
    flat = torch.zeros(offset + B * L * H * row, dtype=torch.bfloat16)
    return flat[offset:].view(B, L, H, row)[..., :D]


def _packed_qkv_view(shape):
    B, L, H, D = shape
    return torch.zeros(B, L, 3, H, D, dtype=torch.bfloat16).unbind(2)[1]


FLASH_ARG_CASES = {
    "contiguous": (lambda s: _bf16_view(s), None),
    "packed_qkv_view": (_packed_qkv_view, None),
    "odd_head_stride": (lambda s: _bf16_view(s, last=s[3] + 1), ValueError),
    "head_stride_not_multiple_of_8": (lambda s: _bf16_view(s, last=s[3] + 2),
                                      ValueError),
    "pointer_2_bytes_off": (lambda s: _bf16_view(s, offset=1), ValueError),
    "pointer_8_bytes_off": (lambda s: _bf16_view(s, offset=4), ValueError),
}


@pytest.mark.parametrize("name", sorted(FLASH_ARG_CASES))
def test_flash_args_need_16_byte_rows(name):
    """The kernel copies 16-byte chunks: the wrapper takes a unit last
    stride, other strides that are multiples of 8 elements and a 16-byte
    aligned pointer, and raises on anything else (no silent copy)."""
    make, err = FLASH_ARG_CASES[name]
    shape = (1, 130, 2, 64)
    q = make(shape)
    k = v = _bf16_view(shape)
    assert q.shape == shape
    if err is None:
        tatt._check_flash_args(q, k, v, True, None)
        tatt._check_flash_args(k, q, q, False, None)
    else:
        with pytest.raises(err, match="16-byte"):
            tatt._check_flash_args(q, k, v, True, None)
        with pytest.raises(err, match="16-byte"):
            tatt._check_flash_args(k, k, q, False, None)
