"""The JAX side and the checks of the mesh training tests
(`tests/test_torch_mesh_train_*.py`): JAX's train step on the global
batch (`jax_steps`), the port's steps on gloo meshes of data 2 and of
(data 2, model 2) (`mesh_runs`, through `tests/torch_dist_worker.py`'s
`mesh_train`), and their comparison (`check_metrics`, `check_state`).

Tolerance 1e-4 abs + rel for the metrics, the gradient norm and every
master and moment after the steps, with one exception. Adam's step is
lr * m / (sqrt(v) + eps), about lr * sign(g) in its first steps, so
where a gradient is at the level of its rounding the two runs' steps
differ by up to the learning rate either way. A tensor whose exact
gradient is zero (a key bias under a softmax, a bias right before a
norm) is such noise throughout: its master (JAX gradient below `NOISE`
of the global norm at every step, but not all zero: an unused tensor
stays as it was and is compared) is held within 2 * lr a step. So is a
single element of a master whose JAX gradient is, at some step, within
`TINY` of the largest of its tensor's; every other element is held to
1e-4.
"""

from __future__ import annotations

import numpy as np
import optax
import torch

import jax

from tests.test_torch_train import _capture_grads, _port_names
from tests.torch_dist_worker import start

TOL = 1e-4
NOISE = 1e-6
TINY = 1e-4
MESHES = {"data2": (2, 1), "data2_model2": (4, 2)}
DATA2 = {"data2": MESHES["data2"]}


def f32(tree):
    """A flax param tree of numpy arrays in fp32 (`random_flax_params`
    leaves some in fp64; both packages compute in fp32 from the same
    rounding, and the gloo ranks load half the bytes)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _adam_trees(opt_state, trainable):
    """(mu, nu) as trees shaped like `trainable`, merged over the
    optimizer's parameter groups (each group's `ScaleByAdamState`)."""
    leaves, treedef = jax.tree_util.tree_flatten(trainable)
    mu, nu = [None] * len(leaves), [None] * len(leaves)

    def is_adam(x):
        return isinstance(x, optax.ScaleByAdamState)

    def is_masked(x):
        return isinstance(x, optax.MaskedNode)
    for a in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam):
        if not is_adam(a):
            continue
        for out, tree in ((mu, a.mu), (nu, a.nu)):
            for i, leaf in enumerate(jax.tree_util.tree_leaves(
                    tree, is_leaf=is_masked)):
                if not is_masked(leaf):
                    out[i] = np.asarray(leaf)
    return treedef.unflatten(mu), treedef.unflatten(nu)


def jax_steps(params, tx_of, make_step, batches, keys, jstep, jfrozen,
              accum=1):
    """JAX's step (`make_step(tx)`, at XLA level 0) once for each global
    batch and key, from `params`, the optimizer `tx_of(trainable)` behind a
    gradient capture: each step's metrics with `grad_norm` (of the
    gradient the update sees: the mean of the `accum`-step accumulation's
    micro-steps so far), the final trainable params (the masters), both
    moments and each step's gradients, as flax trees."""
    from tests.test_torch_unipose import o0_jit

    trainable = jstep.split_frozen(params, jfrozen)[0]
    tx = optax.chain(_capture_grads(), tx_of(trainable))
    state = jstep.TrainState.create(params, tx, frozen=jfrozen)
    fn = o0_jit(make_step(tx))
    metrics, grads = [], []
    for i, (batch, key) in enumerate(zip(batches, keys)):
        state, m = fn(state, batch, key)
        grads.append(jax.tree.map(np.asarray, state.opt_state[0]))
        m = {n: float(v) for n, v in m.items()}
        leaves = [jax.tree_util.tree_leaves(t)
                  for t in grads[(i // accum) * accum:]]
        mean = [sum(x) / len(leaves) for x in zip(*leaves)]
        m["grad_norm"] = float(np.sqrt(sum(
            np.sum(np.asarray(x, np.float64) ** 2) for x in mean)))
        metrics.append(m)
    mu, nu = _adam_trees(state.opt_state[1], trainable)
    masters = jstep.split_frozen(jax.tree.map(np.asarray, state.params),
                                 jfrozen)[0]
    return {"metrics": metrics, "masters": masters, "mu": mu, "nu": nu,
            "grads": grads}


def mesh_runs(cases, workdir, meshes=MESHES):
    """Start each of `cases` (the worker's `mesh_train` cases without
    `n_model`) on each mesh of `meshes` ({name: (world, n_model)}), one
    spawn of gloo ranks a mesh, all at once; returns the call that waits
    for them: {mesh: [each rank's results]}."""
    waits = {}
    for name, (world, n_model) in meshes.items():
        d = workdir / name
        d.mkdir()
        torch.save({"cases": {c: dict(case, n_model=n_model)
                              for c, case in cases.items()}},
                   d / "inputs.pt")
        waits[name] = start("mesh_train", world, str(d))
    return lambda: {name: wait() for name, wait in waits.items()}


def check_metrics(ranks, want, case):
    """Every rank reports the same metrics, the global batch's: JAX's
    within TOL, key for key (with `grad_norm`)."""
    got = ranks[0][case]["metrics"]
    for r in ranks[1:]:
        assert r[case]["metrics"] == got
    assert len(got) == len(want["metrics"])
    for i, (g, w) in enumerate(zip(got, want["metrics"])):
        assert sorted(g) == sorted(w), (i, sorted(g), sorted(w))
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, rtol=TOL, atol=TOL,
                                       err_msg=f"{case} step {i}: {k}")


def check_state(ranks, want, case, model, lr):
    """The gathered masters and both moments against JAX's trees mapped
    to the port's names (`_port_names` of the port `model`), within TOL;
    the masters of noise-only gradients (see the module docstring)
    within 2 * lr a step of JAX's."""
    state = ranks[0][case]["state"]
    steps = len(want["metrics"])
    norms = [np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                         for x in jax.tree_util.tree_leaves(g)))
             for g in want["grads"]]
    grads = [_port_names(model, g) for g in want["grads"]]
    noise = {n for n in grads[0]
             if all(np.linalg.norm(g[n]) <= NOISE * norm
                    for g, norm in zip(grads, norms))
             and any(np.any(g[n]) for g in grads)}
    bound = 2.02 * lr * steps
    checked = 0
    for part in ("masters", "mu", "nu"):
        ref = _port_names(model, want[part])
        assert sorted(ref) == sorted(state[part]), part
        for n, w in ref.items():
            g = state[part][n]
            if part == "masters" and n in noise:
                assert np.abs(g - w).max() <= bound, n
                continue
            if part == "masters":
                tiny = np.zeros(w.shape, bool)
                for gs in grads:
                    tiny |= np.abs(gs[n]) <= TINY * np.abs(gs[n]).max()
                assert np.abs(g - w)[tiny].max(initial=0) <= bound, n
                g, w = g[~tiny], w[~tiny]
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{case} {part} {n}")
            checked += 1
    assert checked > 2.5 * len(state["masters"]), (checked, noise)
    return noise
