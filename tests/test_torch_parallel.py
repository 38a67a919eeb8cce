"""The port's multihost helpers, ring attention, GPipe pipeline and
sequence constraints in gloo process groups on the CPU, against the JAX
package on its 8 virtual CPU devices.

Each module fixture spawns its ranks once (`tests/torch_dist_worker.py`,
one thread a rank, a `file://` store in a temporary directory) and the
tests read the ranks' results:

* multihost, 2 ranks: the assertions of `tests/test_multihost.py`.
* ring attention, 4 context ranks (and 2 data x 2 context): causal and
  not, and GQA, against JAX's `ring_attention_spmd` on its (2, 4) mesh
  at 2e-5, JAX's own tolerance.
* GPipe, 4 ranks: the (layers, stages, microbatches) cases (4, 4, 2),
  (8, 4, 4) and (4, 2, 1) against the JAX `LlamaModel` at 2e-4; the
  backward's gradients, gathered to rank 0, at atol 5e-5 / rtol 5e-4;
  indivisible layers or batch raise `ValueError`.
* `constrain_seq`, 4 ranks: JAX's no-op cases return the input itself;
  a DTensor under a (data 2, context 2) mesh is split as JAX pins it,
  with its values unchanged; a LLaMA prefill under the mesh equals one
  without.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from tests.torch_dist_worker import run
from visionllm_tpu.config import LLMConfig as JaxLLMConfig
from visionllm_tpu.models.llama import LlamaModel as JaxLlama
from visionllm_tpu.ops.ring_attention import ring_attention_spmd
from visionllm_tpu_torch.config import LLMConfig
from visionllm_tpu_torch.models.llama import LlamaModel
from visionllm_tpu_torch.utils.convert import load_jax_params

WORLD = 4


def _spawn(name, world, tmp_path_factory, inputs):
    workdir = tmp_path_factory.mktemp(name)
    torch.save(inputs, workdir / "inputs.pt")
    return run(name, world, str(workdir))


def _np_tree(params, kw=None):
    """numpy copy of a flax tree; with `kw` (an LLM's config) the zero
    embedding table that a `LlamaModel` fed with embeddings never makes."""
    tree = jax.tree.map(np.asarray, params)
    if kw is not None:
        tree = dict(tree, embed_tokens={"embedding": np.zeros(
            (kw["vocab_size"], kw["hidden_size"]), np.float32)})
    return tree


# ---------------------------------------------------------------- multihost

@pytest.fixture(scope="module")
def multihost(tmp_path_factory):
    return _spawn("multihost", 2, tmp_path_factory, {})


def test_two_rank_shard_and_gather(multihost):
    for pid, res in enumerate(multihost):
        # contiguous, disjoint split: rank 0 gets 4, rank 1 gets 3
        assert res["idx"] == (list(range(0, 4)) if pid == 0
                              else list(range(4, 7)))
        merged = res["merged"]
        assert [r["i"] for r in merged] == list(range(7))
        assert [r["host"] for r in merged] == [0, 0, 0, 0, 1, 1, 1]
        assert [len(r["blob"]) for r in merged] == [10] * 4 + [100] * 3


def test_single_process_passthrough():
    from visionllm_tpu_torch.parallel.multihost import (all_gather_objects,
                                                        shard_indices)
    assert shard_indices(5) == list(range(5))
    assert all_gather_objects(({"a": 1},)) == [{"a": 1}]


# ---------------------------------------------------------------- ring

RING_CASES = {"dense": (False, 4), "causal": (True, 4), "gqa": (True, 2)}


@pytest.fixture(scope="module")
def ring(tmp_path_factory):
    rng = np.random.RandomState(0)
    B, L, H, D = 2, 128, 4, 16
    cases, want = {}, {}
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                ("data", "context"))
    for name, (causal, h_kv) in RING_CASES.items():
        q = rng.randn(B, L, H, D).astype(np.float32)
        k = rng.randn(B, L, h_kv, D).astype(np.float32)
        v = rng.randn(B, L, h_kv, D).astype(np.float32)
        cases[name] = {"q": q, "k": k, "v": v, "causal": causal}
        want[name] = np.asarray(jax.jit(lambda a, b, c: ring_attention_spmd(
            a, b, c, mesh, causal=causal))(q, k, v))
    got = _spawn("ring", WORLD, tmp_path_factory, {"ring": cases})
    return got, want


@pytest.mark.parametrize("mesh", ["context", "data_context"])
@pytest.mark.parametrize("case", sorted(RING_CASES))
def test_ring_matches_jax(ring, case, mesh):
    got, want = ring
    for rank in range(WORLD):
        np.testing.assert_allclose(got[rank][f"{case}/{mesh}"], want[case],
                                   atol=2e-5, rtol=2e-5,
                                   err_msg=f"rank {rank}")


def test_ring_step_single_block_is_attention():
    """One block through `ring_step` from the empty state is the plain
    attention of that block (fp32 on the CPU)."""
    from visionllm_tpu_torch.ops.attention import multi_head_attention
    from visionllm_tpu_torch.ops.ring_attention import ring_init, ring_step
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 32, 4, 16, generator=g) for _ in range(3))
    acc, lse = ring_init(q)
    acc, _ = ring_step(q, k[:, :, :2], v[:, :, :2], acc, lse, q_block=0,
                       kv_block=0, causal=True)
    kk, vv = (t[:, :, :2].repeat_interleave(2, dim=2) for t in (k, v))
    torch.testing.assert_close(acc, multi_head_attention(q, kk, vv,
                                                         causal=True),
                               atol=2e-6, rtol=2e-6)


# ---------------------------------------------------------------- pipeline

PIPE_KW = dict(vocab_size=61, hidden_size=32, intermediate_size=64,
               num_heads=4, num_kv_heads=4, max_position_embeddings=64)
PIPE_CASES = [(4, 4, 2), (8, 4, 4), (4, 2, 1)]


def _jax_llama(n_layers, embeds, pos):
    model = JaxLlama(JaxLLMConfig(num_layers=n_layers, **PIPE_KW),
                     dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), embeds, pos)["params"]
    return model, params


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    B, L = 4, 16
    rng = np.random.RandomState(0)
    embeds = rng.randn(B, L, PIPE_KW["hidden_size"]).astype(np.float32)
    pos = np.broadcast_to(np.arange(L)[None], (B, L)).astype(np.int32)
    params, want = {}, {}
    for n in (4, 8):
        model, p = _jax_llama(n, embeds, pos)
        params[n] = _np_tree(p, PIPE_KW)
        want[n] = np.asarray(jax.jit(lambda pp: model.apply(
            {"params": pp}, embeds, pos)[1])(p))
    model4, p4 = _jax_llama(4, embeds, pos)

    def loss(pp):
        _, logits, _ = model4.apply({"params": pp}, embeds, pos)
        return jnp.sum(logits ** 2) / logits.size

    grads = _np_tree(jax.jit(jax.grad(loss))(p4), PIPE_KW)
    odd = {6: _np_tree(_jax_llama(6, embeds, pos)[1], PIPE_KW), 4: params[4]}
    inputs = {"cfg": PIPE_KW, "embeds": embeds, "pos": pos.astype(np.int64),
              "cases": {c: params[c[0]] for c in PIPE_CASES}, "odd": odd}
    got = _spawn("pipeline", WORLD, tmp_path_factory, inputs)
    return got, want, grads


@pytest.mark.parametrize("case", PIPE_CASES, ids=str)
def test_pipeline_matches_unsharded(pipeline, case):
    got, want, _ = pipeline
    for rank in range(WORLD):
        np.testing.assert_allclose(got[rank][case], want[case[0]], atol=2e-4,
                                   rtol=2e-4, err_msg=f"rank {rank}")


def test_pipeline_backward_matches_unsharded(pipeline):
    """`loss.backward()` on every rank runs the GPipe schedule backwards;
    each parameter's gradient (gathered to rank 0) equals JAX's."""
    got, _, grads = pipeline
    ref = LlamaModel(LLMConfig(num_layers=4, **PIPE_KW))
    load_jax_params(ref, grads)    # JAX's gradient tree, in the port layout
    want = dict(ref.named_parameters())
    mine = got[0]["grads"]
    # the embedding is not on the pipeline's path
    assert set(mine) == set(want) - {"embed_tokens.weight"}
    for name, g in mine.items():
        np.testing.assert_allclose(g, want[name].detach().numpy(), atol=5e-5,
                                   rtol=5e-4, err_msg=name)


def test_pipeline_rejects_indivisible(pipeline):
    errors = pipeline[0][0]["errors"]
    assert len(errors) == 2
    assert "6 layers do not split over 4" in errors[0]
    assert "batch 4 does not split into 3" in errors[1]


# ---------------------------------------------------------------- sequence

SEQ_KW = dict(vocab_size=97, hidden_size=32, intermediate_size=64,
              num_layers=2, num_heads=4, num_kv_heads=4,
              max_position_embeddings=128)


@pytest.fixture(scope="module")
def constrain(tmp_path_factory):
    B, L = 2, 64
    embeds = np.random.RandomState(0).randn(B, L, 32).astype(np.float32)
    pos = np.broadcast_to(np.arange(L)[None], (B, L)).astype(np.int64)
    model = JaxLlama(JaxLLMConfig(**SEQ_KW), dtype=jnp.float32)
    params = model.init(jax.random.PRNGKey(0), embeds, pos)["params"]
    want = np.asarray(jax.jit(lambda p: model.apply(
        {"params": p}, embeds, pos)[1])(params))
    x = np.random.RandomState(1).randn(2, 64, 32).astype(np.float32)
    inputs = {"x": x, "cfg": SEQ_KW, "params": _np_tree(params, SEQ_KW),
              "embeds": embeds, "pos": pos}
    return _spawn("constrain", WORLD, tmp_path_factory, inputs), x, want


def test_constrain_seq_noop_cases(constrain):
    for res in constrain[0]:
        assert res["same"] == {k: True for k in res["same"]}
        assert set(res["same"]) == {"no_mesh", "no_context_axis",
                                    "indivisible", "decode", "plain_tensor",
                                    "context_of_one"}


def test_constrain_seq_splits_sequence_and_batch(constrain):
    results, x, _ = constrain
    for res in results:
        assert res["placements"] == [("Shard", 0), ("Shard", 1),
                                     ("Replicate", None)]
        np.testing.assert_array_equal(res["full"], x * np.float32(1.5))


def test_prefill_under_context_mesh_matches_jax(constrain):
    results, _, want = constrain
    for res in results:
        np.testing.assert_array_equal(res["logits_mesh"], res["logits_plain"])
        np.testing.assert_allclose(res["logits_mesh"], want, atol=1e-4,
                                   rtol=1e-4)
