"""The port's CUDA kernels against their plain PyTorch versions on a CUDA
card. They skip on hosts without one; on a machine with a card (and no
JAX) run them with

    python -m pytest --noconftest -q tests/test_torch_kernels_gpu.py

and one kernel's cases alone with `-k flash` (or `-k attention_lse`, the
ring attention's block; `-k int4`, `-k msda`;
`-k int8` the int8 serving modes' library products; `-k "dcnv3 or
internvit or internlm2"` the 26B det path's shapes).

Inputs are made with numpy from a seed. Tolerance: max abs err within
0.02 + 0.01 * max|plain| (bf16 outputs, each rounded from fp32 sums
taken in another order), for each output of a backward kernel against
autograd of the plain forward.
"""

import numpy as np
import pytest
import torch

from visionllm_tpu_torch.ops import attention as A
from visionllm_tpu_torch.ops import gather as G
from visionllm_tpu_torch.ops import ms_deform_attn as M
from visionllm_tpu_torch.ops import quant as Q8
from visionllm_tpu_torch.ops import quant4 as Q
from visionllm_tpu_torch.ops.dcnv3 import dcnv3_msda_args


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a CUDA card")
    return torch.device("cuda")


def _close(got, want):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= 0.02 + 0.01 * want.float().abs().max().item(), err


def _bf16(rng, dev, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)
                            ).to(dev).to(torch.bfloat16)


# (B, L, H, H_kv, D, causal, segmented[, Lk]); Lk defaults to L. The seed
# of a case is its place in this dict.
FLASH = {
    "causal_d128": (1, 586, 8, 8, 128, True, False),
    "gqa": (2, 130, 8, 2, 128, True, False),
    "noncausal_d64": (1, 577, 16, 16, 64, False, False),
    "one_token": (3, 1, 4, 4, 64, True, False),
    "segments": (2, 200, 4, 4, 64, True, True),
    "segments_noncausal": (2, 97, 4, 4, 128, False, True),
    "tile_edges": (1, 65, 2, 2, 64, False, False),
    "len_128": (1, 128, 4, 4, 128, True, False),
    "len_129": (1, 129, 4, 4, 64, True, False),
    "lq100_lk300": (2, 100, 8, 2, 128, False, False, 300),
    "chat_prefill_b4": (4, 640, 32, 32, 128, True, False),
    "long_d64": (1, 2048, 8, 8, 64, True, False),
    "long_d128": (1, 2048, 8, 8, 128, True, False),
    # a slot service's B1 prefill: a 600-token prompt left-padded to 640
    "slot_prefill_leftpad": (1, 640, 32, 32, 128, True, "leftpad"),
    # the 26B det path: InternViT-6B over a 7-tile stack (1025 tokens, 25
    # heads of 128, bidirectional) and InternLM2-20B's causal prefill at
    # 48 heads over 8 KV heads (6:1)
    "internvit_b7_l1025": (7, 1025, 25, 25, 128, False, False),
    "internlm2_gqa_6to1": (1, 1900, 48, 8, 128, True, False),
}


def _flash_case(name, seed_offset, dev, with_dout=False):
    """q, k, v (, dout), segment ids and causal of a FLASH case."""
    B, L, H, Hkv, D, causal, segmented, *rest = FLASH[name]
    Lk = rest[0] if rest else L
    rng = np.random.default_rng(seed_offset + list(FLASH).index(name))
    q = _bf16(rng, dev, B, L, H, D)
    k, v = (_bf16(rng, dev, B, Lk, Hkv, D) for _ in range(2))
    dout = _bf16(rng, dev, B, L, H, D) if with_dout else None
    seg = None
    if segmented == "leftpad":
        seg = torch.ones(B, L, dtype=torch.int32, device=dev)
        seg[:, :40] = 0
    elif segmented:
        seg = torch.from_numpy(rng.integers(0, 3, (B, L)).astype(np.int32)
                               ).to(dev)
    return q, k, v, dout, seg, causal


@pytest.mark.parametrize("name", list(FLASH))
def test_flash_kernel_matches_plain(cuda, name):
    q, k, v, _, seg, causal = _flash_case(name, 0, cuda)
    n = A.flash_attention.launches
    got = A.flash_attention(q, k, v, causal=causal, segment_ids=seg)
    assert A.flash_attention.launches == n + 1
    want = A.flash_attention_plain(q, k, v, causal=causal, segment_ids=seg)
    torch.cuda.synchronize()
    _close(got, want)


@pytest.mark.parametrize("name", ["causal_d128", "segments", "lq100_lk300",
                                  "long_d64"])
def test_flash_kernel_is_deterministic(cuda, name):
    """Two calls on the same input are bit-identical, output and lse."""
    q, k, v, _, seg, causal = _flash_case(name, 0, cuda)
    B, Lq, H, _ = q.shape
    runs = []
    for _ in range(2):
        lse = torch.empty(B, H, Lq, dtype=torch.float32, device=cuda)
        runs.append((A._launch_fwd(q, k, v, causal, seg, lse), lse))
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


@pytest.mark.parametrize("name", ["causal_d128", "gqa", "segments",
                                  "lq100_lk300"])
def test_flash_lse_and_autograd_match_plain(cuda, name):
    """The forward's row logsumexp against the plain scores' (-inf where a
    row attends no key) within 1e-3 (fp32 sums of bf16 products taken in
    another order, and the kernel's ex2.approx), and dq/dk/dv of autograd
    through
    `FlashAttentionFn` (forward kernel, its lse into the backward kernel)
    against autograd of the plain forward."""
    q, k, v, dout, seg, causal = _flash_case(name, 300, cuda, True)
    B, Lq, H, D = q.shape
    Lk, Hkv = k.shape[1], k.shape[2]
    lse = torch.empty(B, H, Lq, dtype=torch.float32, device=cuda)
    A._launch_fwd(q, k, v, causal, seg, lse)
    kr = k.float().repeat_interleave(H // Hkv, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr) * D ** -0.5
    allowed = torch.ones(B, 1, Lq, Lk, dtype=torch.bool, device=cuda)
    if causal:
        allowed = allowed & torch.ones(Lq, Lk, dtype=torch.bool,
                                       device=cuda).tril()
    if seg is not None:
        allowed = allowed & (seg[:, None, :, None] == seg[:, None, None, :])
    want_lse = torch.logsumexp(scores.masked_fill(~allowed, -float("inf")),
                               dim=-1)
    torch.cuda.synchronize()
    finite = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), finite)
    assert (lse[finite] - want_lse[finite]).abs().max().item() <= 1e-3
    qkv = [t.detach().requires_grad_() for t in (q, k, v)]
    n = A.flash_attention_bwd.launches
    out = A.flash_attention(*qkv, causal=causal, segment_ids=seg)
    got = torch.autograd.grad(out, qkv, dout)
    assert A.flash_attention_bwd.launches == n + 1
    want = A.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                       segment_ids=seg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close(g, w)


@pytest.mark.parametrize("name", ["causal_d128", "gqa", "long_d128"])
def test_attention_lse_kernel_matches_plain(cuda, name):
    """`attention_lse` (the ring's block) on bf16 CUDA inputs launches
    the flash kernel once and returns its bf16 output within the kernel
    gate and its row logsumexp within 1e-3 of `attention_lse_plain`'s
    fp32 pair; fp32 inputs take the plain pair and launch nothing."""
    q, k, v, _, _, causal = _flash_case(name, 600, cuda)
    n = A.flash_attention.launches
    out, lse = A.attention_lse(q, k, v, causal=causal)
    assert A.flash_attention.launches == n + 1
    want, want_lse = A.attention_lse_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    _close(out, want)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    plain = A.attention_lse(q.float(), k.float(), v.float(), causal=causal)
    assert A.flash_attention.launches == n + 1
    assert torch.equal(plain[1], A.attention_lse_plain(
        q.float(), k.float(), v.float(), causal=causal)[1])


def test_flash_kernel_takes_strided_views(cuda):
    rng = np.random.default_rng(7)
    qkv = _bf16(rng, cuda, 1, 150, 3, 8, 64)          # packed [B, L, 3, H, D]
    q, k, v = qkv.unbind(2)
    got = A.flash_attention(q, k, v)
    want = A.flash_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _close(got, want)


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(TypeError):
        A.flash_attention(q, q, q)                     # float32
    qb = q.bfloat16()
    with pytest.raises(ValueError):
        A.flash_attention(qb, qb[:, :4], qb[:, :4], causal=True)
    with pytest.raises(ValueError):
        A.flash_attention(qb[..., :32], qb[..., :32], qb[..., :32])


SHAPES = ((64, 64), (32, 32), (16, 16), (8, 8))


@pytest.mark.parametrize("Q", [5440, 900, 1])
def test_msda_kernel_matches_plain(cuda, Q):
    rng = np.random.default_rng(Q)
    S = sum(h * w for h, w in SHAPES)
    value = _bf16(rng, cuda, 1, S, 8, 32)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (1, Q, 8, 4, 4, 2))
                           .astype(np.float32)).to(cuda)
    attw = torch.from_numpy(rng.random((1, Q, 8, 4, 4)).astype(np.float32)
                            ).to(cuda)
    n = M.ms_deform_attn.launches
    got = M.ms_deform_attn(value, SHAPES, loc, attw)
    assert M.ms_deform_attn.launches == n + 1
    want = M.ms_deform_attn_plain(value, SHAPES, loc, attw)
    torch.cuda.synchronize()
    _close(got, want)


# the 800 px test scale's levels (the 800x1088 bucket at Swin-T strides
# 8-64, S = 18071) and its two new query counts: the encoder (Q = S) and
# UniPose's post-expansion decoder (50 groups x (1 box + 68 keypoints) =
# 3450 queries), whose locations come from 4-d box references as in
# `DeformableAttention`
PERCEPTION_SHAPES = ((100, 136), (50, 68), (25, 34), (13, 17))


@pytest.mark.parametrize("case", ["perception_encoder", "pose_decoder"])
def test_msda_kernel_matches_plain_at_perception_shapes(cuda, case):
    rng = np.random.default_rng(18071 if case == "perception_encoder"
                                else 3450)
    S = sum(h * w for h, w in PERCEPTION_SHAPES)
    value = _bf16(rng, cuda, 1, S, 8, 32)
    if case == "perception_encoder":
        loc = rng.uniform(-0.2, 1.2, (1, S, 8, 4, 4, 2))
    else:
        Q = 3450
        ref = np.concatenate([rng.uniform(0.0, 1.0, (1, Q, 2)),
                              rng.uniform(0.01, 0.5, (1, Q, 2))], -1)
        off = 2.0 * rng.standard_normal((1, Q, 8, 4, 4, 2))
        loc = (ref[:, :, None, None, None, :2]
               + off / 4 * ref[:, :, None, None, None, 2:] * 0.5)
    loc = torch.from_numpy(loc.astype(np.float32)).to(cuda)
    logits = torch.from_numpy(rng.standard_normal(
        loc.shape[:3] + (16,)).astype(np.float32)).to(cuda)
    attw = torch.softmax(logits, -1).reshape(loc.shape[:5])
    n = M.ms_deform_attn.launches
    got = M.ms_deform_attn(value, PERCEPTION_SHAPES, loc, attw)
    assert M.ms_deform_attn.launches == n + 1
    want = M.ms_deform_attn_plain(value, PERCEPTION_SHAPES, loc, attw)
    torch.cuda.synchronize()
    _close(got, want)


# DCNv3 in InternImage-H at the 800x1088 det bucket: one level (the
# zero-padded stage map), 9 points, the groups as heads, 32 channels a
# group; (stage map H, W, groups)
DCNV3_STAGES = {"stage0": (200, 272, 10), "stage1": (100, 136, 20),
                "stage2": (50, 68, 40), "stage3": (25, 34, 80)}


@pytest.mark.parametrize("stage", list(DCNV3_STAGES))
def test_msda_kernel_matches_plain_at_dcnv3_shapes(cuda, stage):
    """Locations and weights as `dcnv3_core` builds them: the 3x3 taps
    around each pixel plus offsets of a few pixels, and a mask softmaxed
    over the 9 points and rounded to bf16."""
    H, W, G = DCNV3_STAGES[stage]
    rng = np.random.default_rng(list(DCNV3_STAGES).index(stage) + 400)
    x = _bf16(rng, cuda, 1, H, W, 32 * G)
    off = torch.from_numpy(2.0 * rng.standard_normal(
        (1, H, W, G * 18)).astype(np.float32)).to(cuda)
    logits = torch.from_numpy(rng.standard_normal(
        (1, H, W, G, 9)).astype(np.float32)).to(cuda)
    mask = torch.softmax(logits, -1).reshape(1, H, W, G * 9).to(
        torch.bfloat16)
    (value, shapes, loc, attw), _ = dcnv3_msda_args(x, off, mask, group=G)
    assert shapes == ((H + 2, W + 2),) and loc.shape[1:5] == (H * W, G, 1, 9)
    n = M.ms_deform_attn.launches
    got = M.ms_deform_attn(value, shapes, loc, attw)
    assert M.ms_deform_attn.launches == n + 1
    want = M.ms_deform_attn_plain(value, shapes, loc, attw)
    torch.cuda.synchronize()
    _close(got, want)


def test_msda_kernel_far_and_nonfinite_locations_are_zero(cuda):
    value = torch.ones(2, 5 * 7, 2, 64, device=cuda, dtype=torch.bfloat16)
    loc = torch.full((2, 3, 2, 1, 2, 2), 1e9, device=cuda)
    loc[0] = float("nan")
    attw = torch.ones(2, 3, 2, 1, 2, device=cuda)
    got = M.ms_deform_attn(value, ((5, 7),), loc, attw)
    torch.cuda.synchronize()
    assert torch.count_nonzero(got) == 0


# (D, level shapes, P) of the generic kernel instance (the specialised one
# is D 32, L 4, P 4): a sample group of 8, 2, 3 and 5 threads (D 64, 16,
# 24, 40), odd level sizes, and a head row wider than a warp's 32 chunks
MSDA_GENERIC = {
    "d64_l1_p2": (64, ((13, 17),), 2),
    "d16_l3_p3": (16, ((7, 9), (5, 3), (1, 1)), 3),
    "d24_l2_p5": (24, ((6, 11), (3, 6)), 5),
    "d40_l8_p1": (40, ((9, 9), (8, 7), (6, 5), (5, 4), (4, 3), (3, 2),
                       (2, 2), (1, 1)), 1),
    "d264_l2_p3": (264, ((5, 6), (2, 3)), 3),
}


def _msda_case(rng, dev, D, shapes, P, Q=29, B=2, H=3):
    S = sum(h * w for h, w in shapes)
    L = len(shapes)
    value = _bf16(rng, dev, B, S, H, D)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, Q, H, L, P, 2))
                           .astype(np.float32)).to(dev)
    attw = torch.from_numpy(rng.random((B, Q, H, L, P)).astype(np.float32)
                            ).to(dev)
    gout = _bf16(rng, dev, B, Q, H * D)
    return value, loc, attw, gout


@pytest.mark.parametrize("name", list(MSDA_GENERIC))
def test_msda_generic_instance_matches_plain(cuda, name):
    """The generic instance (any D that is a multiple of 8, any L <= 8 and
    P), forward and backward, one launch a call each."""
    D, shapes, P = MSDA_GENERIC[name]
    rng = np.random.default_rng(list(MSDA_GENERIC).index(name) + 300)
    value, loc, attw, gout = _msda_case(rng, cuda, D, shapes, P)
    n, nb = M.ms_deform_attn.launches, M.ms_deform_attn_bwd.launches
    got = M.ms_deform_attn(value, shapes, loc, attw)
    gots = M.ms_deform_attn_bwd(value, shapes, loc, attw, gout)
    assert (M.ms_deform_attn.launches, M.ms_deform_attn_bwd.launches) \
        == (n + 1, nb + 1)
    want = M.ms_deform_attn_plain(value, shapes, loc, attw)
    wants = M.ms_deform_attn_bwd_plain(value, shapes, loc, attw, gout)
    torch.cuda.synchronize()
    _close(got, want)
    for g, w in zip(gots, wants):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w)


@pytest.mark.parametrize("D,shapes,P,Q,B", [
    (32, SHAPES, 4, 2100, 2),
    (16, ((40, 40), (20, 20), (9, 11), (5, 5)), 3, 2049, 1),
    (32, ((3, 3), (1, 1)), 1, 4000, 1)],
    ids=["specialised_b2", "generic", "all_coarse"])
def test_msda_bwd_privatised_matches_plain(cuda, D, shapes, P, Q, B):
    """Calls with 2048 queries or more sum the coarse levels' grad_value
    rows in shared memory per (batch, head, query tile) and add them to
    the output once per block: the same gradients as the plain backward,
    at a batch of two, a generic shape, and one whose every level is
    coarse (a level smaller than a sample group's reach)."""
    rng = np.random.default_rng(Q)
    value, loc, attw, gout = _msda_case(rng, cuda, D, shapes, P, Q=Q, B=B,
                                        H=8)
    n = M.ms_deform_attn_bwd.launches
    gots = M.ms_deform_attn_bwd(value, shapes, loc, attw, gout)
    assert M.ms_deform_attn_bwd.launches == n + 1
    wants = M.ms_deform_attn_bwd_plain(value, shapes, loc, attw, gout)
    torch.cuda.synchronize()
    for g, w in zip(gots, wants):
        _close(g, w)


def test_msda_kernels_take_misaligned_views(cuda):
    """A value view 2 bytes past a 16-byte boundary (and locations 4
    bytes past one) breaks the kernels' vector loads: the wrapper copies
    it, and both kernels still match the plain version."""
    rng = np.random.default_rng(11)
    value, loc, attw, gout = _msda_case(rng, cuda, 32, SHAPES, 4, Q=40,
                                        B=1, H=8)
    vbuf = torch.empty(value.numel() + 1, dtype=value.dtype, device=cuda)
    vbuf[1:] = value.flatten()
    lbuf = torch.empty(loc.numel() + 1, dtype=loc.dtype, device=cuda)
    lbuf[1:] = loc.flatten()
    value_v, loc_v = vbuf[1:].view(value.shape), lbuf[1:].view(loc.shape)
    assert value_v.data_ptr() % 16 and loc_v.data_ptr() % 16
    got = M.ms_deform_attn(value_v, SHAPES, loc_v, attw)
    gots = M.ms_deform_attn_bwd(value_v, SHAPES, loc_v, attw, gout)
    torch.cuda.synchronize()
    _close(got, M.ms_deform_attn_plain(value, SHAPES, loc, attw))
    for g, w in zip(gots, M.ms_deform_attn_bwd_plain(value, SHAPES, loc,
                                                     attw, gout)):
        _close(g, w)


@pytest.mark.parametrize("D,shapes,P,Q", [
    (32, SHAPES, 4, 900), (*MSDA_GENERIC["d16_l3_p3"], 900),
    (32, SHAPES, 4, 5440)], ids=["specialised", "generic", "privatised"])
def test_msda_kernels_repeat(cuda, D, shapes, P, Q):
    """Two calls on the same inputs: the forward bit-identical (a fixed
    order of sums); in the backward grad_loc and grad_attw bit-identical,
    and grad_value, summed by fp32 atomics in an order that changes from
    run to run, only within the kernels' tolerance of each other (not
    bitwise)."""
    rng = np.random.default_rng(12)
    value, loc, attw, gout = _msda_case(rng, cuda, D, shapes, P, Q=Q,
                                        B=1, H=8)
    outs = [M.ms_deform_attn(value, shapes, loc, attw) for _ in range(2)]
    grads = [M.ms_deform_attn_bwd(value, shapes, loc, attw, gout)
             for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*outs)
    _close(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    assert torch.equal(grads[0][2], grads[1][2])


def _int4_weights(rng, dev, K, N):
    w = torch.from_numpy(rng.normal(0, 0.05, (K, N)).astype(np.float32))
    wp, scale = Q.pack_int4(w.to(dev))
    return wp, scale


# (M, K, N): decode and short prompts (16-row tiles), the byte-staged
# width 200, lm_head's 32096, the chat prefill (B4 x L640), groups of 96
# rows (K 192), which the kernel pads to 128 with zeros, and a slot
# service's shapes: a tick of 8 slots at every LLaMA-7B projection width
# and lm_head, and a 256-token chunk window
INT4 = [(m, 11008, n) for m in (1, 3, 17, 129) for n in (200, 32096)] \
    + [(2560, 4096, 11008), (5, 192, 64), (129, 192, 200)] \
    + [(8, k, n) for k, n in ((4096, 4096), (4096, 11008), (11008, 4096),
                              (4096, 32096))] + [(256, 4096, 11008)]


@pytest.mark.parametrize("M_,K,N", INT4,
                         ids=[f"m{m}_k{k}_n{n}" for m, k, n in INT4])
def test_int4_kernel_matches_plain(cuda, M_, K, N):
    rng = np.random.default_rng(M_ * 7 + N)
    wp, scale = _int4_weights(rng, cuda, K, N)
    x = _bf16(rng, cuda, M_, K)
    n = Q.int4_matmul.launches
    got = Q.int4_matmul(x, wp, scale)
    assert Q.int4_matmul.launches == n + 1
    want = Q.int4_matmul_plain(x, wp, scale)
    torch.cuda.synchronize()
    assert got.shape == (M_, N) and got.dtype == torch.bfloat16
    _close(got, want)


@pytest.mark.parametrize("N", [4096, 201])
def test_int4_kernel_rows_are_batch_invariant(cuda, N):
    """Every row of an M = 4, 17, 129 or 640 call (16-row and 64-row
    tiles, several column tiles) is bit-identical to the M = 1 call on
    that row, and so are the rows of an M = 4 call that starts at row 3.
    N 201 takes the byte-staged weights."""
    rng = np.random.default_rng(N)
    wp, scale = _int4_weights(rng, cuda, 4096, N)
    x = _bf16(rng, cuda, 640, 4096)
    alone = torch.stack([Q.int4_matmul(x[i:i + 1], wp, scale)[0]
                         for i in range(640)])
    for m in (4, 17, 129, 640):
        assert torch.equal(Q.int4_matmul(x[:m], wp, scale), alone[:m]), m
    assert torch.equal(Q.int4_matmul(x[3:7], wp, scale), alone[3:7])


def test_int4_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    rng = np.random.default_rng(3)
    wp, scale = _int4_weights(rng, cuda, 512, 64)
    x = _bf16(rng, cuda, 2, 512)
    with pytest.raises(TypeError):
        Q.int4_matmul(x.float(), wp, scale)            # float32 x
    with pytest.raises(TypeError):
        Q.int4_matmul(x, wp.to(torch.uint8), scale)    # not int8
    with pytest.raises(ValueError):
        Q.int4_matmul(_bf16(rng, cuda, 512, 2).t(), wp, scale)  # strided
    with pytest.raises(ValueError):                    # row stride 516
        Q.int4_matmul(_bf16(rng, cuda, 2, 516)[:, :512], wp, scale)
    with pytest.raises(ValueError):                    # 8-byte aligned x
        Q.int4_matmul(_bf16(rng, cuda, 2, 520)[:, 4:516], wp, scale)
    with pytest.raises(ValueError):                    # K % (2 G) != 0
        Q.int4_matmul(x[:, :384], wp[:192], scale[:3])


# ---------------------------------------------------------------------------
# the int8 serving modes' library products on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M_", [1, 4, 16, 17, 640])
def test_int8_matmul_is_exact_on_the_card(cuda, M_):
    """`torch._int_mm` (rows zero-padded to 17 below it) gives the exact
    int32 product, equal to the CPU's int32 matmul."""
    rng = np.random.default_rng(M_)
    xq = torch.from_numpy(rng.integers(-127, 128, (M_, 4096)).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (200, 4096)).astype(np.int8))
    got = Q8.int8_matmul(xq.to(cuda), wq.to(cuda))
    assert got.shape == (M_, 200) and got.dtype == torch.int32
    assert torch.equal(got.cpu(), Q8.int8_matmul_plain(xq, wq))


def test_int8_matmul_rejects_unaligned_widths(cuda):
    xq = torch.zeros(4, 100, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        Q8.int8_matmul(xq, torch.zeros(64, 100, dtype=torch.int8,
                                       device=cuda))


def test_int8_quantization_and_modules_match_the_cpu(cuda):
    """`quantize_int8`, `quantize_kv` and `Int8ActLinear` (exact int32
    accumulation, then the same fp32 scaling) give the CPU's bits on the
    card; `Int8Linear` (a bf16 GEMM) stays within the tolerance."""
    rng = np.random.default_rng(8)
    w = torch.from_numpy(rng.normal(0, 0.05, (200, 512)).astype(np.float32))
    kv = _bf16(rng, cuda, 2, 9, 4, 128)
    for got, want in zip(Q8.quantize_int8(w.to(cuda), dim=-1),
                         Q8.quantize_int8(w, dim=-1)):
        assert torch.equal(got.cpu(), want)
    for got, want in zip(Q8.quantize_kv(kv), Q8.quantize_kv(kv.cpu())):
        assert torch.equal(got.cpu(), want)
    lin = torch.nn.Linear(512, 200, bias=False)
    lin.weight.data.copy_(w)
    x = _bf16(rng, cuda, 5, 512)
    for cls in (Q8.Int8ActLinear, Q8.Int8Linear):
        cpu_mod = cls.from_linear(lin.to(torch.bfloat16))
        card_mod = cls.sharing(cpu_mod).to(cuda)
        got, want = card_mod(x), cpu_mod(x.cpu())
        if cls is Q8.Int8ActLinear:
            assert torch.equal(got.cpu(), want)
        else:
            _close(got.cpu(), want)


# ---------------------------------------------------------------------------
# backward kernels, the gather probes, and autograd through the wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FLASH))
def test_flash_bwd_kernel_matches_autograd_of_plain(cuda, name):
    q, k, v, dout, seg, causal = _flash_case(name, 100, cuda, True)
    B, L, H, _ = q.shape
    lse = torch.empty(B, H, L, dtype=torch.float32, device=cuda)
    out = A._launch_fwd(q, k, v, causal, seg, lse)
    n = A.flash_attention_bwd.launches
    got = A.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                segment_ids=seg)
    assert A.flash_attention_bwd.launches == n + 1
    want = A.flash_attention_bwd_plain(q, k, v, dout, causal=causal,
                                       segment_ids=seg)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _close(g, w)


@pytest.mark.parametrize("name", ["causal_d128", "gqa", "segments",
                                  "lq100_lk300", "long_d128"])
def test_flash_bwd_kernel_is_deterministic(cuda, name):
    """Two backward calls on the same inputs give bit-identical dq, dk and
    dv: no atomics, every sum in a fixed order (GQA's over the group's
    heads too)."""
    q, k, v, dout, seg, causal = _flash_case(name, 100, cuda, True)
    B, L, H, _ = q.shape
    lse = torch.empty(B, H, L, dtype=torch.float32, device=cuda)
    out = A._launch_fwd(q, k, v, causal, seg, lse)
    runs = [A.flash_attention_bwd(q, k, v, out, dout, lse, causal=causal,
                                  segment_ids=seg) for _ in range(2)]
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("Q", [1100, 37, 1])
def test_msda_bwd_kernel_matches_autograd_of_plain(cuda, Q):
    rng = np.random.default_rng(200 + Q)
    S = sum(h * w for h, w in SHAPES)
    value = _bf16(rng, cuda, 1, S, 8, 32)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (1, Q, 8, 4, 4, 2))
                           .astype(np.float32)).to(cuda)
    attw = torch.from_numpy(rng.random((1, Q, 8, 4, 4)).astype(np.float32)
                            ).to(cuda)
    gout = _bf16(rng, cuda, 1, Q, 8 * 32)
    n = M.ms_deform_attn_bwd.launches
    got = M.ms_deform_attn_bwd(value, SHAPES, loc, attw, gout)
    assert M.ms_deform_attn_bwd.launches == n + 1
    want = M.ms_deform_attn_bwd_plain(value, SHAPES, loc, attw, gout)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        _close(g, w)


def test_backward_through_the_wrappers_reaches_every_input(cuda):
    """The inference wrappers cut nothing from autograd: loss.backward()
    through flash_attention and ms_deform_attn launches the backward
    kernels and fills every input's gradient."""
    rng = np.random.default_rng(5)
    q, k, v = (_bf16(rng, cuda, 1, 70, 4, 64).requires_grad_()
               for _ in range(3))
    f0, b0 = A.flash_attention.launches, A.flash_attention_bwd.launches
    A.flash_attention(q, k, v, causal=True).float().square().sum().backward()
    assert (A.flash_attention.launches, A.flash_attention_bwd.launches) \
        == (f0 + 1, b0 + 1)
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (q, k, v))
    S = sum(h * w for h, w in SHAPES)
    value = _bf16(rng, cuda, 1, S, 8, 32).requires_grad_()
    loc = torch.from_numpy(rng.uniform(0, 1, (1, 50, 8, 4, 4, 2)).astype(
        np.float32)).to(cuda).requires_grad_()
    attw = torch.from_numpy(rng.random((1, 50, 8, 4, 4)).astype(np.float32)
                            ).to(cuda).requires_grad_()
    m0, mb0 = M.ms_deform_attn.launches, M.ms_deform_attn_bwd.launches
    M.ms_deform_attn(value, SHAPES, loc, attw).float().square().sum() \
        .backward()
    assert (M.ms_deform_attn.launches, M.ms_deform_attn_bwd.launches) \
        == (m0 + 1, mb0 + 1)
    assert all(t.grad is not None and t.grad.abs().sum() > 0
               for t in (value, loc, attw))
    with torch.no_grad():                  # inference keeps one launch
        f0, b0 = A.flash_attention.launches, A.flash_attention_bwd.launches
        A.flash_attention(q, k, v)
        assert (A.flash_attention.launches,
                A.flash_attention_bwd.launches) == (f0 + 1, b0)


def _grads_with_remat(mode, layer, inputs):
    """Output and input gradients of `layer` run under
    `remat_call(mode, ALL_DOTS, ...)`, and the flash and MSDA launches
    (forward, backward) it made."""
    from visionllm_tpu_torch.models.remat import ALL_DOTS, remat_call
    leaves = [t.detach().requires_grad_() for t in inputs]
    c0 = (A.flash_attention.launches, A.flash_attention_bwd.launches,
          M.ms_deform_attn.launches, M.ms_deform_attn_bwd.launches)
    out = remat_call(mode, ALL_DOTS, layer, *leaves)
    grads = torch.autograd.grad(out.float().square().sum(), leaves)
    torch.cuda.synchronize()
    c1 = (A.flash_attention.launches, A.flash_attention_bwd.launches,
          M.ms_deform_attn.launches, M.ms_deform_attn_bwd.launches)
    return out.detach(), grads, tuple(b - a for a, b in zip(c0, c1))


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_flash_under_checkpoint_equals_the_kernels_without(cuda, mode):
    """A projection, the flash kernel (causal, B2 L256, 8 heads of 64) and
    a projection, rematerialized: the forward kernel runs again in the
    backward (2 forward launches, 1 backward), and the output and every
    gradient equal the run without remat bit for bit (both flash kernels
    are deterministic)."""
    rng = np.random.default_rng(31)
    x = _bf16(rng, cuda, 2, 256, 512)
    wq = 0.05 * _bf16(rng, cuda, 512, 3 * 512)
    wo = 0.05 * _bf16(rng, cuda, 512, 512)

    def layer(x, wq, wo):
        q, k, v = (x @ wq).reshape(2, 256, 3, 8, 64).unbind(2)
        return A.flash_attention(q, k, v, causal=True).reshape(
            2, 256, 512) @ wo

    out0, g0, n0 = _grads_with_remat("", layer, (x, wq, wo))
    out1, g1, n1 = _grads_with_remat(mode, layer, (x, wq, wo))
    assert (n0, n1) == ((1, 1, 0, 0), (2, 1, 0, 0))
    assert torch.equal(out0, out1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mode", ["full", "dots"])
def test_msda_under_checkpoint_matches_the_kernels_without(cuda, mode):
    """A value projection and the MSDA kernel (the det encoder's levels,
    Q 300), rematerialized: 2 forward launches and 1 backward; the output
    bit for bit and the gradients within the kernel tolerance of the run
    without remat (the backward adds grad_value with atomics)."""
    rng = np.random.default_rng(32)
    S = sum(h * w for h, w in SHAPES)
    x = _bf16(rng, cuda, 1, S, 256)
    wv = 0.05 * _bf16(rng, cuda, 256, 256)
    loc = torch.from_numpy(rng.uniform(-0.2, 1.2, (1, 300, 8, 4, 4, 2))
                           .astype(np.float32)).to(cuda)
    attw = torch.from_numpy(rng.random((1, 300, 8, 4, 4)).astype(np.float32)
                            ).to(cuda)

    def layer(x, wv, loc, attw):
        return M.ms_deform_attn((x @ wv).reshape(1, S, 8, 32), SHAPES, loc,
                                attw)

    out0, g0, n0 = _grads_with_remat("", layer, (x, wv, loc, attw))
    out1, g1, n1 = _grads_with_remat(mode, layer, (x, wv, loc, attw))
    assert (n0, n1) == ((0, 0, 1, 1), (0, 0, 2, 1))
    assert torch.equal(out0, out1)
    for a, b in zip(g0, g1):
        _close(b, a)


def test_int4_raises_under_grad(cuda):
    rng = np.random.default_rng(3)
    wp, scale = _int4_weights(rng, cuda, 512, 64)
    x = _bf16(rng, cuda, 2, 512).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        Q.int4_matmul(x, wp, scale)
    with torch.no_grad():
        assert Q.int4_matmul(x, wp, scale).shape == (2, 64)


# (R, E, reversed): random indices in [-2, E + 2) unless reversed. 1025
# and 1028 are just past one CTA a row: a two-CTA cluster with a ragged
# second slice, by scalar (odd E) and by 16-byte accesses.
LANE = [(8, 128, False), (8, 256, False), (3, 1000, False),
        (2, 57344, False), (8, 57344, False), (8, 57343, False),
        (8, 1025, False), (8, 1028, False), (8, 57344, True)]


@pytest.mark.parametrize("R,E,rev", LANE)
def test_lane_gather_kernel_matches_plain(cuda, R, E, rev):
    rng = np.random.default_rng(E)
    v = torch.from_numpy(rng.standard_normal((R, E)).astype(np.float32)
                         ).to(cuda)
    if rev:
        idx = torch.arange(E - 1, -1, -1, dtype=torch.int32,
                           device=cuda).expand(R, E).contiguous()
    else:
        idx = torch.from_numpy(rng.integers(-2, E + 2, (R, E)).astype(
            np.int32)).to(cuda)
    n = G.lane_gather.launches
    got = G.lane_gather(v, idx)
    assert G.lane_gather.launches == n + 1
    assert torch.equal(got, G.lane_gather_plain(v, idx))
    if rev:
        assert torch.equal(got, v.flip(1))


def test_lane_gather_misaligned_rows(cuda):
    """Rows 4 bytes off a 16-byte boundary take the scalar accesses."""
    R, E = 8, 4096
    rng = np.random.default_rng(1)
    flat = torch.from_numpy(rng.standard_normal(R * E + 1).astype(
        np.float32)).to(cuda)
    v = flat[1:].view(R, E)
    idx = torch.from_numpy(rng.integers(-2, E + 2, (R, E)).astype(np.int32)
                           ).to(cuda)
    assert v.is_contiguous() and v.data_ptr() % 16 == 4
    assert torch.equal(G.lane_gather(v, idx), G.lane_gather_plain(v, idx))


def test_lane_gather_cluster_sizes(cuda):
    """One CTA a row up to 1024 floats, two just past it, 16 at the
    probe's largest extent; each shape fits on the card."""
    got = {E: G.lane_gather_plan(E) for E in (128, 1024, 1025, 57344)}
    assert [got[E]["cluster"] for E in got] == [1, 1, 2, 16]
    assert got[1025]["chunk"] == 516
    assert all(p["active"] >= 1 for p in got.values())


@pytest.mark.parametrize("rpb,n", [(8, 8192), (64, 1000), (64, 131072),
                                   (5, 77)])
def test_row_gather_kernel_matches_plain(cuda, rpb, n):
    rng = np.random.default_rng(n + rpb)
    table = _bf16(rng, cuda, 16384, 128)
    idx = torch.from_numpy(rng.integers(-3, 16387, n).astype(np.int32)
                           ).to(cuda)
    k = G.row_gather.launches
    got = G.row_gather(table, idx, rpb)
    assert G.row_gather.launches == k + 1
    assert torch.equal(got, G.row_gather_plain(table, idx))


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

def small_cli_config():
    """The tiny config (region encoder on) widened so that attention takes
    the flash kernel: 64-wide heads in CLIP and the LLM and a 168 px image
    (145 vision tokens, prompts over 128). At `--tiny` itself no attention
    qualifies (head dim 8, 17 vision tokens)."""
    import dataclasses

    from visionllm_tpu_torch.config import tiny_test_config
    cfg = tiny_test_config(use_region_encoder=True)
    r = dataclasses.replace
    return r(cfg,
             vis_encoder=r(cfg.vis_encoder, image_size=168, hidden_size=128,
                           intermediate_size=256, num_heads=2),
             llm=r(cfg.llm, hidden_size=128, intermediate_size=256,
                   num_heads=2, num_kv_heads=2),
             gdino=r(cfg.gdino, text_dim=128),
             unipose=r(cfg.unipose, text_dim=128),
             region_encoder=r(cfg.region_encoder, embed_dim=128,
                              out_dim=128))


def write_npy_coco(root):
    """Two seeded .npy images (the card's machine has no Pillow) with two
    polygon objects each, as a COCO instances file."""
    import json
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i, (h, w) in enumerate(((64, 80), (72, 56))):
        np.save(root / f"im{i}.npy", rng.integers(0, 256, (h, w, 3),
                                                  dtype=np.uint8))
        images.append({"id": i, "file_name": f"im{i}.npy", "height": h,
                       "width": w})
        for j, (x, y, bw, bh) in enumerate(((4, 5, 20, 16), (30, 22, 18,
                                                               24))):
            anns.append({"id": 10 * i + j, "image_id": i,
                         "category_id": 1 + j, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "segmentation": [[x, y, x + bw, y, x + bw, y + bh,
                                           x, y + bh]]})
    path = root / "instances.json"
    path.write_text(json.dumps({
        "images": images, "annotations": anns,
        "categories": [{"id": 1, "name": "cat"}, {"id": 2, "name": "dog"}]}))
    return str(path)


def test_cli_eval_interactive_launches_the_kernels(cuda, tmp_path, capsys):
    """`cli.main(["eval-interactive", ...])` on the card (its default
    device) in bf16 on a small model config: one JSON line with
    `region_acc@0.5`, and the flash and MSDA kernels launched."""
    import json

    from visionllm_tpu_torch import cli
    (tmp_path / "cfg.json").write_text(small_cli_config().to_json())
    ann = write_npy_coco(tmp_path)
    f0, m0 = A.flash_attention.launches, M.ms_deform_attn.launches
    cli.main(["eval-interactive", "--model-config",
              str(tmp_path / "cfg.json"), "--ann", ann, "--imgs",
              str(tmp_path), "--limit", "2"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) == {"region_acc@0.5"}
    assert 0.0 <= out["region_acc@0.5"] <= 1.0
    assert A.flash_attention.launches - f0 > 0
    assert M.ms_deform_attn.launches - m0 > 0

