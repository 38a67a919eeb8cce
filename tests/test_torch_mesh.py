"""The port's mesh rules against the JAX package's, without processes.

* Placement parity: for every parameter of the tiny composite with every
  tool, the port's `shard_params` on the axis sizes {"data": 4,
  "context": 1, "model": 2} gives the axis JAX's
  `MeshRules.fsdp_tp().spec_for` gives its flax leaf on
  `build_mesh(n_data=4, n_model=2)`, on the same logical dim. The flax
  tree comes from JAX's converter of the port's state written under the
  reference's keys, and each flax dim is followed to its port dim
  through `load_jax_params`'s own layout map (strided views whose
  strides name the flax dims).
* `fit_spec`'s trim and drop cases against JAX's `_fit_spec`.
* `shard_batch` of a collated batch against the slices of JAX's
  `shard_batch` shardings, for each data rank.
* `build_mesh` and `init_process_group_for` refuse what JAX asserts and
  what the port does not run.
"""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import PartitionSpec as P

from tests import torch_ref_layout as W
from visionllm_tpu import config as jconfig
from visionllm_tpu.parallel import mesh as jmesh
from visionllm_tpu.utils import torch_convert as JT
from visionllm_tpu_torch import config as pconfig
from visionllm_tpu_torch.data.collator import collate
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.parallel import mesh as pmesh
from visionllm_tpu_torch.utils.convert import _emit

SIZES = {"data": 4, "context": 1, "model": 2}
HEAD = dict(llm_hidden_size=64, sd_hidden_size=32, num_queries=7,
            num_embs_gen=8, sample_size=16, cross_attention_dim=32)


def _all_tools(mod):
    return mod.tiny_test_config(
        use_region_encoder=True, use_sd=True, sd=mod.SDConfig(**HEAD),
        use_ip2p=True, ip2p=mod.IP2PConfig(**HEAD))


@pytest.fixture(scope="module")
def composite():
    torch.set_num_threads(1)
    model = build_model(_all_tools(pconfig), device="cpu",
                        dtype=torch.float32, seed=3)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    ref = {k: v.numpy() for k, v in
           W.write_composite(state, _all_tools(pconfig)).items()}
    tree = JT.convert_composite(ref, _all_tools(jconfig))
    return model, tree


def _port_layout(model, tree):
    """{port parameter: (its flax leaf's path, the flax dim of each of its
    dims)}: every flax leaf goes through `load_jax_params`'s layout map
    as a view whose stride on dim j names the leaf n and the dim
    (64 (16 n + j + 1)); no data is read."""
    base = np.zeros(1, np.int8)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    paths = ["/".join(k.key for k in path) for path, _ in flat]

    def view(n, x):
        shape = np.shape(x)
        strides = tuple(64 * (16 * n + j + 1) for j in range(len(shape)))
        return np.lib.stride_tricks.as_strided(base, shape, strides)

    views = jax.tree_util.tree_unflatten(
        treedef, [view(n, x) for n, (_, x) in enumerate(flat)])
    out = {}
    _emit(model, "", views, out)
    params = dict(model.named_parameters())
    res = {}
    for name, a in out.items():
        if name in params:
            codes = [s // 64 - 1 for s in a.strides]
            leaves = {c // 16 for c in codes}
            assert len(leaves) == 1, name
            res[name] = (paths[leaves.pop()], tuple(c % 16 for c in codes))
    return res


def test_spec_for_matches_jax_for_every_parameter(composite):
    model, tree = composite
    layout = _port_layout(model, tree)
    params = dict(model.named_parameters())
    assert set(layout) == set(params)
    mesh = jmesh.build_mesh(n_data=4, n_model=2)
    rules = jmesh.MeshRules.fsdp_tp()
    shapes = {"/".join(k.key for k in path): np.shape(x) for path, x in
              jax.tree_util.tree_flatten_with_path(tree)[0]}
    got = pmesh.shard_params(model, SIZES)
    assert set(got) == set(params)
    n_split = 0
    for name, p in params.items():
        path, dims = layout[name]
        jspec = tuple(rules.spec_for(path, shapes[path], mesh))
        jspec += (None,) * (len(shapes[path]) - len(jspec))
        want = tuple(jspec[fd] for fd in dims)
        # a scanned stack's layer axis (the flax dim no port dim has) is
        # never split
        assert all(jspec[fd] is None for fd in range(len(jspec))
                   if fd not in dims), name
        assert got[name] == want, (name, path, got[name], jspec)
        n_split += any(a is not None for a in want)
    assert n_split > 100
    assert any("model" in s for s in got.values())


@pytest.mark.parametrize("spec,shape", [
    ((None, "data", "model"), (64, 128)),      # trim the stack axis
    (("model", "data"), (7, 12)),               # drop the undivided model
    ((None, "data"), (4, 3, 3, 8)),             # a short spec pads right
    (("data",), (2,)),                          # dim smaller than the axis
    ((None, "model", "data"), (3, 8, 16)),
    ((), (5, 5)),
])
def test_fit_spec_matches_jax(spec, shape):
    mesh = jmesh.build_mesh(n_data=4, n_model=2)
    want = tuple(jmesh._fit_spec(P(*spec), shape, mesh))
    assert pmesh.fit_spec(spec, shape, SIZES) == want


class _FakeAxis:
    def __init__(self, size, rank):
        self._size, self._rank = size, rank

    def size(self):
        return self._size

    def get_local_rank(self):
        return self._rank


def test_shard_batch_matches_jax_slices():
    rng = np.random.default_rng(0)

    def sample(i, n_box):
        return {"input_ids": list(rng.integers(4, 90, 5 + i)),
                "labels": list(rng.integers(4, 90, 5 + i)),
                "image": rng.standard_normal((8, 8, 3)).astype(np.float32),
                "targets": {"boxes": np.ones((n_box, 4), np.float32),
                            "labels": np.arange(n_box)},
                "img_metas": {"id": i, "scale": np.ones(4, np.float32)},
                "captions": f"caption {i}"}

    batch = collate([sample(i, 3) for i in range(8)])
    batch["num_boxes"] = np.float32(24.0)
    batch["odd"] = np.zeros((6, 2), np.float32)     # 6 rows: kept whole
    mesh = jmesh.build_mesh(n_data=4, n_model=2)
    shardings = jmesh.shard_batch(batch, mesh)
    for r in range(4):
        got = pmesh.shard_batch(batch, {"data": _FakeAxis(4, r)})
        dev = mesh.devices[r, 0, 0]

        def want(x, sh):
            if np.ndim(x) == 0:
                return x
            return np.asarray(x)[sh.devices_indices_map(np.shape(x))[dev]]

        expect = jax.tree.map(want, batch, shardings)
        flat_g = jax.tree_util.tree_leaves(got)
        flat_w = jax.tree_util.tree_leaves(expect)
        assert len(flat_g) == len(flat_w)
        for g, w in zip(flat_g, flat_w):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
        assert got["input_ids"].shape[0] == 2 and got["odd"].shape[0] == 6


def test_build_mesh_and_group_refusals():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group_for"):
        pmesh.build_mesh()
    with pytest.raises(ValueError, match="cuda or cpu"):
        pmesh.init_process_group_for("meta", init_method="file:///dev/null",
                                     world_size=1, rank=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pmesh.init_process_group_for(None, init_method="file:///x",
                                         world_size=1, rank=0)
