"""The port's training data plane and Trainer on the CPU: `collate` and
`_seq_bucket`, the samplers, `PrefetchLoader` and the npz interchange
against the JAX package exactly; the checkpoint directory; and
`Trainer.train` at `tiny_test_config` on COCO-style JPEGs (4 straight
steps, and 2 steps + resume in a fresh Trainer + 2 steps, which must end
bit for bit where the straight run does; its first step's metrics row
against the JAX Trainer's on the same batch; a non-finite step stopping
the run).

The Trainer runs use `HashedWordTokenizer` (a word's id is a hash, so
loader threads tokenize in any order to the same ids) and
`torch.use_deterministic_algorithms(True)`: PyTorch's CPU backward of an
indexed parameter (`emb_embeddings_det[off_p]`) otherwise sums in thread
order, which would hide the resume's own exactness.
"""

import dataclasses
import json
import os
import random
import threading
import time

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp
import optax

from tests.mock_tokenizer import MockTokenizer
from tests.test_torch_train import _capture_grads, jax_noise
from tests.torch_dist_worker import run
from visionllm_tpu.config import tiny_test_config as jax_tiny_config
from visionllm_tpu.data import build as jbuild
from visionllm_tpu.data import collator as jcollator
from visionllm_tpu.data.loader import PrefetchLoader as JaxLoader
from visionllm_tpu.models.composite import VisionLLMWithTools as JaxModel
from visionllm_tpu.models.visionllm import SpecialTokenIds as JaxTid
from visionllm_tpu.parallel.mesh import build_mesh
from visionllm_tpu.train import runner as jrunner
from visionllm_tpu.train import train_step as jstep
from visionllm_tpu.utils import checkpoint as jckpt
from visionllm_tpu_torch.config import OptimizerConfig, tiny_test_config
from visionllm_tpu_torch.data import build as tbuild
from visionllm_tpu_torch.data import collator as tcollator
from visionllm_tpu_torch.data.loader import PrefetchLoader
from visionllm_tpu_torch.models.composite import build_model
from visionllm_tpu_torch.models.visionllm import SpecialTokenIds
from visionllm_tpu_torch.train.runner import TrainConfig, Trainer
from visionllm_tpu_torch.utils import checkpoint as tckpt
from visionllm_tpu_torch.utils.convert import load_jax_params
from visionllm_tpu_torch.utils.simple_tokenizer import HashedWordTokenizer


# ---------------------------------------------------------------------------
# collate
# ---------------------------------------------------------------------------

def _sample(rng, n_ids, hw, with_targets=True):
    s = {"input_ids": rng.integers(0, 100, n_ids).tolist(),
         "labels": rng.integers(-100, 100, n_ids).tolist(),
         "image": rng.standard_normal((8, 8, 3)).astype(np.float32),
         "image_aug": rng.standard_normal((*hw, 3)).astype(np.float32),
         "pixel_mask": np.ones(hw, bool),
         "img_metas": {"task": "det", "n": n_ids}}
    if with_targets:
        s["targets"] = {"boxes": rng.random((4, 4)).astype(np.float32),
                        "labels": rng.integers(0, 5, 4).astype(np.int32),
                        "masks": rng.random((4, hw[0] // 4, hw[1] // 4))
                        .astype(np.float32)}
    return s


@pytest.mark.parametrize("mixed", [False, True])
def test_collate_matches_jax(mixed):
    rng = np.random.default_rng(int(mixed))
    hws = [(16, 24), (24, 16), (16, 16)] if mixed else [(16, 24)] * 3
    samples = [_sample(rng, n, hw) for n, hw in zip((7, 600, 33), hws)]
    want = jcollator.collate(samples, pad_token_id=5)
    got = tcollator.collate(samples, pad_token_id=5)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype
            np.testing.assert_array_equal(got[k], v)
        elif isinstance(v, dict):
            for kk in v:
                np.testing.assert_array_equal(got[k][kk], v[kk])
        else:
            assert got[k] == v


def test_seq_bucket_matches_jax():
    for n in (1, 511, 512, 513, 2048, 4095, 4096, 9000):
        assert tcollator._seq_bucket(n) == jcollator._seq_bucket(n)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

class _Sized:
    def __init__(self, n, task):
        self.n, self.task = n, task

    def __len__(self):
        return self.n


@pytest.mark.parametrize("seed,drop_last", [(0, True), (7, False)])
def test_task_grouped_batch_sampler_matches_jax(seed, drop_last):
    parts = [(13, "det"), (9, "pose"), (11, "grd"), (7, "chat"),
             (5, "t2i")]
    jc = jbuild.ConcatDataset([_Sized(n, t) for n, t in parts])
    tc = tbuild.ConcatDataset([_Sized(n, t) for n, t in parts])
    want = list(jbuild.TaskGroupedBatchSampler(jc, 3, seed, drop_last))
    got = list(tbuild.TaskGroupedBatchSampler(tc, 3, seed, drop_last))
    assert got == want
    assert len(tbuild.TaskGroupedBatchSampler(tc, 3)) == \
        len(jbuild.TaskGroupedBatchSampler(jc, 3))
    for b in got:
        assert len({tbuild.group_of_task(tc.task_of(i)) for i in b}) == 1


def test_length_grouped_functions_match_jax():
    rng = np.random.default_rng(3)
    lengths = rng.integers(1, 500, 40).tolist()
    for chunks in (2, 3, 4):
        idx = list(range(len(lengths)))
        assert tbuild.split_to_even_chunks(idx, lengths, chunks) == \
            jbuild.split_to_even_chunks(idx, lengths, chunks)
    assert tbuild.get_length_grouped_indices(
        lengths, 4, 2, random.Random(5)) == jbuild.get_length_grouped_indices(
        lengths, 4, 2, random.Random(5))
    signed = [n if i % 3 else -n for i, n in enumerate(lengths)]
    assert tbuild.get_modality_length_grouped_indices(
        signed, 3, 2, random.Random(6)) == \
        jbuild.get_modality_length_grouped_indices(signed, 3, 2,
                                                   random.Random(6))


@pytest.mark.parametrize("modality", [False, True])
def test_length_grouped_sampler_matches_jax(modality):
    rng = np.random.default_rng(4)
    lengths = [int(n) * (1 if i % 4 else -1) if modality else int(n)
               for i, n in enumerate(rng.integers(1, 300, 37))]
    for epoch in (0, 2):
        j = jbuild.LengthGroupedSampler(4, 2, lengths, seed=9,
                                        group_by_modality=modality)
        t = tbuild.LengthGroupedSampler(4, 2, lengths, seed=9,
                                        group_by_modality=modality)
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j) and len(t) == len(j)


def test_random_sourced_batch_sampler_matches_jax():
    for epoch in (0, 1):
        j = jbuild.RandomSourcedBatchSampler([10, 7, 13], 4, seed=2)
        t = tbuild.RandomSourcedBatchSampler([10, 7, 13], 4, seed=2)
        j.set_epoch(epoch)
        t.set_epoch(epoch)
        assert list(t) == list(j) and len(t) == len(j)


# ---------------------------------------------------------------------------
# PrefetchLoader
# ---------------------------------------------------------------------------

class _Slow:
    def __init__(self, n, delay=0.0, fail_at=None):
        self.n, self.delay, self.fail_at = n, delay, fail_at
        self.built = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.built.append(i)
        if i == self.fail_at:
            raise ValueError(f"bad sample {i}")
        if self.delay:
            time.sleep(self.delay * ((i * 7) % 3))
        return {"x": np.full((3,), i, np.int32)}


def _coll(samples):
    return np.stack([s["x"] for s in samples])


def _batches(n, bs):
    return [list(range(i, i + bs)) for i in range(0, n - n % bs, bs)]


@pytest.mark.parametrize("num_workers", [0, 1, 3])
def test_loader_order_and_content_match_jax(num_workers):
    ds = _Slow(23, delay=0.002)
    want = list(JaxLoader(ds, _batches(23, 4), _coll,
                          num_workers=num_workers))
    got = list(PrefetchLoader(ds, _batches(23, 4), _coll,
                              num_workers=num_workers))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    flat = list(PrefetchLoader(ds, iter(range(10)), _coll, batch_size=3,
                               num_workers=num_workers))
    assert [b[:, 0].tolist() for b in flat] == [[0, 1, 2], [3, 4, 5],
                                                [6, 7, 8]]


def test_loader_raises_a_samples_error_at_its_batch():
    it = iter(PrefetchLoader(_Slow(12, fail_at=5), _batches(12, 4), _coll,
                             num_workers=3))
    np.testing.assert_array_equal(next(it)[:, 0], [0, 1, 2, 3])
    with pytest.raises(ValueError, match="bad sample 5"):
        next(it)


def _loader_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("prefetch-")]


def test_loader_early_break_stops_its_threads():
    ds = _Slow(400, delay=0.001)
    loader = PrefetchLoader(ds, _batches(400, 2), _coll, num_workers=4,
                            depth=3)
    for k, _ in enumerate(loader):
        if k == 2:
            break
    assert not _loader_threads()
    # at most `depth` batches past the consumer were ever started
    assert len(set(ds.built)) <= 2 * (3 + 3)


# ---------------------------------------------------------------------------
# checkpoints and the npz interchange
# ---------------------------------------------------------------------------

def test_checkpoint_directory_keeps_the_last_three(tmp_path):
    d = str(tmp_path / "ck")
    assert tckpt.latest_step(d) is None
    for step in (1, 2, 3, 4, 5):
        tckpt.save_checkpoint(d, step, {"step": step,
                                        "w": {"a": torch.full((2,), step)}})
    assert sorted(os.listdir(d)) == ["3", "4", "5"]
    assert tckpt.latest_step(d) == 5
    ck = tckpt.restore_checkpoint(d, 4)
    assert ck["step"] == 4 and torch.equal(ck["w"]["a"], torch.full((2,), 4))
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path / "none"))


def _clip_dims():
    return dict(image_size=28, patch_size=14, hidden_size=16,
                intermediate_size=32, num_layers=2, num_heads=2)


def test_npz_from_jax_loads_into_the_port(tmp_path):
    from visionllm_tpu.config import VisionEncoderConfig as JCfg
    from visionllm_tpu.models.clip_vit import ClipVisionTower as J
    from visionllm_tpu_torch.config import VisionEncoderConfig as TCfg
    from visionllm_tpu_torch.models.clip_vit import ClipVisionTower as T
    x = np.random.default_rng(0).standard_normal((2, 28, 28, 3)).astype(
        np.float32)
    jm = J(JCfg(**_clip_dims()), jnp.float32)
    params = jm.init(jax.random.PRNGKey(1), x)["params"]
    path = str(tmp_path / "clip.npz")
    jckpt.save_params_npz(path, params)
    tree = tckpt.load_params_npz(path)
    jflat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(jflat) == len(np.load(path).files)
    tm = T(TCfg(**_clip_dims()))
    load_jax_params(tm, tree)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.apply({"params": params},
                                                        x)),
                               rtol=1e-4, atol=1e-4)


def test_npz_from_the_port_loads_in_jax(tmp_path):
    rng = np.random.default_rng(1)
    tree = {"core": {"llm": {"w": torch.randn(3, 4),
                             "b": torch.randn(4).bfloat16()},
                     "bridge": {"0": {"kernel": rng.standard_normal((2, 2))}}},
            "gdino": {"scale": np.float32(2.5)}}
    path = str(tmp_path / "port.npz")
    tckpt.save_params_npz(path, tree)
    got = jckpt.load_params_npz(path)
    np.testing.assert_array_equal(got["core"]["llm"]["w"],
                                  tree["core"]["llm"]["w"].numpy())
    np.testing.assert_array_equal(got["core"]["llm"]["b"],
                                  tree["core"]["llm"]["b"].float().numpy())
    np.testing.assert_array_equal(got["core"]["bridge"]["0"]["kernel"],
                                  tree["core"]["bridge"]["0"]["kernel"])
    assert float(got["gdino"]["scale"]) == 2.5
    back = tckpt.load_params_npz(path)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(got)


def test_merge_param_trees_matches_jax():
    a = {"core": {"x": 1, "y": {"z": 2}}, "gdino": {"w": 3}}
    b = {"core": {"y": {"z": 9, "q": 4}}, "unipose": {"v": 5}}
    assert tckpt.merge_param_trees(a, b) == jckpt.merge_param_trees(a, b)


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("coco_train_port")
    rng = np.random.default_rng(0)
    imgs, anns = [], []
    for i in range(8):
        a = rng.integers(0, 255, (48, 64, 3), dtype=np.uint8)
        Image.fromarray(a).save(d / f"img{i}.jpg", quality=90,
                                progressive=bool(i % 2))
        imgs.append({"id": i, "file_name": f"img{i}.jpg", "width": 64,
                     "height": 48})
        anns.append({"id": i, "image_id": i, "category_id": 1 + i % 2,
                     "bbox": [5 + i, 5, 20, 15], "area": 300,
                     "iscrowd": 0})
    with open(d / "ann.json", "w") as f:
        json.dump({"images": imgs, "annotations": anns,
                   "categories": [{"id": 1, "name": "cat"},
                                  {"id": 2, "name": "dog"}]}, f)
    return d


def _ds_cfgs(coco_dir, cfg):
    return [{"type": "coco_det", "ann_file": str(coco_dir / "ann.json"),
             "img_prefix": str(coco_dir),
             "image_size": cfg.vis_encoder.image_size, "max_gt_per_img": 4,
             "train_scales": [(48, 64)], "buckets": ((64, 64),)}]


def _train(coco_dir, out, steps, num_workers, **tc_kw):
    cfg = tiny_test_config()
    tc = TrainConfig(output_dir=out, batch_size=2, total_steps=100,
                     log_every=1, save_every=2, num_workers=num_workers,
                     optimizer=OptimizerConfig(learning_rate=1e-3,
                                               total_steps=10), **tc_kw)
    trainer = Trainer(cfg, tc, SpecialTokenIds.synthetic(), device="cpu",
                      dtype=torch.float32)
    state = trainer.train(_ds_cfgs(coco_dir, cfg), HashedWordTokenizer(),
                          max_steps=steps)
    return trainer, state, _rows(out)


def _rows(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def runs(coco_dir, tmp_path_factory):
    """4 straight steps at 2 workers; 2 steps at 0 workers, then a fresh
    Trainer resuming to 4 at 3 workers."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        a = str(tmp_path_factory.mktemp("straight"))
        b = str(tmp_path_factory.mktemp("resumed"))
        straight = _train(coco_dir, a, 4, 2)
        first = _train(coco_dir, b, 2, 0)
        resumed = _train(coco_dir, b, 4, 3)
    finally:
        torch.use_deterministic_algorithms(was)
    return {"straight": straight, "first": first, "resumed": resumed,
            "dirs": (a, b)}


def test_trainer_steps_log_and_checkpoint(runs):
    trainer, state, rows = runs["straight"]
    assert state.step == 4 and [r["step"] for r in rows] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
               for r in rows)
    ckpt_dir = os.path.join(runs["dirs"][0], "checkpoints")
    assert tckpt.latest_step(ckpt_dir) == 4
    assert sorted(os.listdir(ckpt_dir)) == ["2", "4"]
    ck = tckpt.restore_checkpoint(ckpt_dir)
    assert ck["position"] == 4 and ck["step"] == 4
    assert set(ck["masters"]) == set(state.masters)
    assert len(trainer.history) == 4
    assert not _loader_threads()


def test_two_plus_resume_plus_two_equals_four_bitwise(runs):
    _, straight, srows = runs["straight"]
    _, first, _ = runs["first"]
    trainer, resumed, rrows = runs["resumed"]
    assert first.step == 2 and resumed.step == 4
    assert [r["position"] for r in trainer.history] == [2, 3]
    assert [r["loss"] for r in rrows] == [r["loss"] for r in srows]
    for n, w in straight.masters.items():
        assert torch.equal(resumed.masters[n], w), n
        assert torch.equal(resumed.mu[n], straight.mu[n]), n
        assert torch.equal(resumed.nu[n], straight.nu[n]), n
    params = dict(resumed.model.named_parameters())
    for n, p in straight.model.named_parameters():
        assert torch.equal(params[n], p), n


def test_trainer_step_matches_jax_trainer(coco_dir, tmp_path, monkeypatch):
    """The JAX Trainer and the port's take their first step on the same
    collated batch, from the same parameters (JAX's init, loaded into the
    port) and the same draws (the JAX step's key), in fp32: the metrics
    row each writes agrees key for key within 1e-4 (`MODEL_TOL` of
    `test_torch_train.py`), and the port's gradient norm is that of the
    JAX step's trainable gradients. The batch is the JAX loader's: the
    port's loader draws each sample's augmentations apart
    (`seeded_sample`), so for one seed the two Trainers take other
    batches. The bucket pads the 48-row images to 64, and JAX's zero
    patch-embedding bias gives both the same very large gradient norm."""
    jcfg = jax_tiny_config(use_unipose=False, use_sd=False, use_ip2p=False,
                           use_region_encoder=False)
    cfg = tiny_test_config(use_unipose=False, unipose=None)
    opt = dict(learning_rate=1e-3, total_steps=10)
    ds_cfgs = _ds_cfgs(coco_dir, cfg)
    seen = {}
    init, init_state = JaxModel.init, jrunner.Trainer.init_state
    build_optimizer, jit_for = jrunner.build_optimizer, jrunner.Trainer._jit_for

    def jitted_init(self, rng, batch, tid):  # eager init takes minutes
        return jax.jit(lambda r, b: init(self, r, b, tid))(rng, batch)

    def keep_params(self, example):
        state = init_state(self, example)
        seen["params"] = jax.tree.map(np.array, state.params)
        return state

    def keep_grads(cfg_, params, frozen=None):
        return optax.chain(_capture_grads(),
                           build_optimizer(cfg_, params, frozen=frozen))

    def keep_batch(self, group, state, batch):
        seen["batch"] = batch
        return jit_for(self, group, state, batch)

    monkeypatch.setattr(JaxModel, "init", jitted_init)
    # one device, as on a one-card host (the port's Trainer runs on one)
    monkeypatch.setattr(jrunner, "build_mesh", lambda n_model: build_mesh(
        n_model=n_model, devices=jax.devices()[:1]))
    monkeypatch.setattr(jrunner.Trainer, "init_state", keep_params)
    monkeypatch.setattr(jrunner, "build_optimizer", keep_grads)
    monkeypatch.setattr(jrunner.Trainer, "_jit_for", keep_batch)
    monkeypatch.setattr(jrunner, "save_checkpoint", lambda *a, **k: None)
    jout = str(tmp_path / "jax")
    jtc = jrunner.TrainConfig(output_dir=jout, batch_size=2, log_every=1,
                              optimizer=jstep.OptimizerConfig(**opt))
    jstate = jrunner.Trainer(jcfg, jtc, JaxTid.synthetic(),
                             dtype=jnp.float32).train(
        ds_cfgs, MockTokenizer(), max_steps=1)
    frozen = jrunner.frozen_predicate(jtc, jcfg)
    grads = jax.tree_util.tree_flatten_with_path(jstate.opt_state[0])[0]
    jax_grad_norm = np.sqrt(sum(
        np.sum(np.asarray(g, np.float64) ** 2) for path, g in grads
        if not frozen("/".join(k.key for k in path))))

    class Replay(Trainer):
        """The port's Trainer on the JAX loader's first batch, with the
        JAX step's draws."""

        def loader(self, concat, batches, start=0):
            yield batches[0], seen["batch"]

        def step_fn_for(self, group):
            step = super().step_fn_for(group)
            key = jax.random.split(jax.random.PRNGKey(self.tc.seed))[1]

            def with_jax_draws(state, batch, generator=None):
                return step(state, batch, noise=jax_noise(
                    key, self.cfg.gdino, batch["targets"]["labels"].shape))
            return with_jax_draws

    tout = str(tmp_path / "port")
    trainer = Replay(cfg, TrainConfig(output_dir=tout, batch_size=2,
                                      log_every=1,
                                      optimizer=OptimizerConfig(**opt)),
                     SpecialTokenIds.synthetic(), device="cpu",
                     dtype=torch.float32)
    trainer.model = build_model(cfg, device="cpu", dtype=torch.float32)
    load_jax_params(trainer.model, seen["params"])
    trainer.train(ds_cfgs, HashedWordTokenizer(), max_steps=1)
    (want,), (got,) = _rows(jout), _rows(tout)
    want["grad_norm"] = jax_grad_norm
    del want["time"], got["time"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def test_non_finite_step_raises_before_logging_or_saving(coco_dir, tmp_path):
    """A step whose gradient norm is not finite stops the run naming the
    step; nothing is logged or checkpointed for it."""

    class Overflow(Trainer):
        def step_fn_for(self, group):
            step = super().step_fn_for(group)

            def overflowing(state, batch, generator=None):
                state, metrics = step(state, batch, generator=generator)
                if state.step == 2:
                    metrics["grad_norm"] = torch.tensor(float("inf"))
                return state, metrics
            return overflowing

    cfg = tiny_test_config()
    out = str(tmp_path)
    tc = TrainConfig(output_dir=out, batch_size=2, log_every=1,
                     save_every=1, num_workers=0,
                     optimizer=OptimizerConfig(learning_rate=1e-3,
                                               total_steps=10))
    trainer = Overflow(cfg, tc, SpecialTokenIds.synthetic(), device="cpu",
                       dtype=torch.float32)
    with pytest.raises(FloatingPointError,
                       match=r"step 2: non-finite \{'grad_norm': inf\}; "
                             r"the last checkpoint is that of step 1"):
        trainer.train(_ds_cfgs(coco_dir, cfg), HashedWordTokenizer(),
                      max_steps=4)
    assert [r["step"] for r in _rows(out)] == [1]
    assert tckpt.latest_step(os.path.join(out, "checkpoints")) == 1
    assert not _loader_threads()


@pytest.mark.parametrize("task,item", [("chat", "A.7")])
def test_other_groups_raise_naming_their_roadmap_item(tmp_path, task, item):
    """No tool group raises any more: the chat group's item (A.7) is
    ported, so its task gets the chat train step."""
    import visionllm_tpu_torch.train.runner as trunner
    assert item not in trunner.NOT_PORTED.values() and not trunner.NOT_PORTED
    tc = TrainConfig(output_dir=str(tmp_path))
    trainer = Trainer(tiny_test_config(), tc, SpecialTokenIds.synthetic(),
                      device="cpu", dtype=torch.float32)
    trainer.init_state()
    step = trainer.step_fn_for(tbuild.group_of_task(task))
    assert trainer.step_fn_for("vlm") is step


def test_tensor_parallel_raises_naming_a8(tmp_path):
    """`Trainer(n_model=2)` on two gloo ranks: a LoRA and an int4 LLM
    raise naming ROADMAP.md A.8.4 where the model is sharded; with no
    process group `n_model > 1` is a `ValueError`."""
    with pytest.raises(ValueError, match="process group"):
        Trainer(tiny_test_config(), TrainConfig(output_dir=str(tmp_path),
                                                n_model=2),
                SpecialTokenIds.synthetic(), device="cpu")
    cfg = tiny_test_config(use_gdino=False, gdino=None, use_unipose=False,
                           unipose=None)
    cfgs = {name: dataclasses.replace(cfg, llm=dataclasses.replace(
        cfg.llm, **kw)) for name, kw in (("lora", {"lora_r": 4}),
                                         ("int4", {"quant": "int4"}))}
    torch.save({"cfgs": cfgs, "out": str(tmp_path)},
               tmp_path / "inputs.pt")
    errors = run("trainer_refusals", 2, str(tmp_path))
    assert errors[0] == errors[1]
    for name in cfgs:
        assert errors[0][name].startswith("NotImplementedError"), errors
        assert "ROADMAP.md A.8.4" in errors[0][name], errors


def test_trainer_without_device_raises_on_cpu_host(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(tiny_test_config(), TrainConfig(output_dir=str(tmp_path)),
                SpecialTokenIds.synthetic())
