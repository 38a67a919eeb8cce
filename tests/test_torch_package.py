"""Guards of the PyTorch port's boundaries: it imports nothing of JAX,
flax, Pillow or the JAX package, and its entry points do not quietly
fall back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "visionllm_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "PIL", "visionllm_tpu",
             "transformers")


def _port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    # the reference-layout writer that chip_smoke.py imports
    yield os.path.join(ROOT, "tests", "torch_ref_layout.py")
    yield os.path.join(ROOT, "tests", "sd15_published_keys.py")


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_imports_nothing_of_jax(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_package_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import visionllm_tpu_torch as pkg\n"
        "for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(info.name)\n"
        "bad = [m for m in sys.modules if m == 'visionllm_tpu'\n"
        "       or m.startswith('visionllm_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_entry_point_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from visionllm_tpu_torch import resolve_device
    from visionllm_tpu_torch.config import tiny_test_config
    from visionllm_tpu_torch.models.composite import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(tiny_test_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"


def test_chat_entry_points_without_device_raise_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from visionllm_tpu_torch.config import tiny_test_config
    from visionllm_tpu_torch.models.composite import build_core
    from visionllm_tpu_torch.serve import ChatService
    from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer
    cfg = tiny_test_config(use_gdino=False, gdino=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_core(cfg)
    core = build_core(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChatService(cfg, core, SimpleTokenizer())
    svc = ChatService(cfg, core, SimpleTokenizer(), device="cpu")
    svc.close()


def test_kernel_wrappers_on_cpu_run_plain_versions_in_bf16():
    """On CPU tensors the wrappers run their plain versions, which keep
    the bf16 dtype the kernels take."""
    from visionllm_tpu_torch.ops import attention, ms_deform_attn
    q = torch.randn(1, 8, 2, 64, dtype=torch.bfloat16)
    assert attention.flash_attention(q, q, q).dtype == torch.bfloat16
    v = torch.randn(1, 5, 2, 4, dtype=torch.bfloat16)
    loc = torch.rand(1, 3, 2, 1, 2, 2)
    attw = torch.rand(1, 3, 2, 1, 2)
    out = ms_deform_attn.ms_deform_attn(v, ((1, 5),), loc, attw)
    assert out.shape == (1, 3, 8) and out.dtype == torch.bfloat16


def test_int4_wrapper_on_cpu_runs_plain_version_in_bf16():
    from visionllm_tpu_torch.ops import quant4
    w = torch.randn(256, 40)
    wp, scale = quant4.pack_int4(w)
    x = torch.randn(3, 256, dtype=torch.bfloat16)
    n = quant4.int4_matmul.launches
    out = quant4.int4_matmul(x, wp, scale)
    assert out.shape == (3, 40) and out.dtype == torch.bfloat16
    assert quant4.int4_matmul.launches == n        # no kernel launched
    assert torch.equal(out, quant4.int4_matmul_plain(x, wp, scale))


def test_perception_entry_points_without_device_raise_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from visionllm_tpu_torch.config import tiny_test_config
    from visionllm_tpu_torch.infer import Predictor
    from visionllm_tpu_torch.models.composite import build_model
    from visionllm_tpu_torch.utils.simple_tokenizer import SimpleTokenizer
    cfg = tiny_test_config()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, None, SimpleTokenizer())
    model = build_model(cfg, device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor(cfg, model, SimpleTokenizer())
    pred = Predictor(cfg, model, SimpleTokenizer(), device="cpu")
    assert pred.device.type == "cpu"


def test_26b_modules_are_among_the_guarded_sources():
    """The import guard above walks the whole package: the 26B det
    path's new modules are in it."""
    paths = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("visionllm_tpu_torch/models/intern_vit.py",
                "visionllm_tpu_torch/models/intern_image.py",
                "visionllm_tpu_torch/ops/dcnv3.py", "chip_smoke.py"):
        assert rel in paths


def test_26b_det_entry_point_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from visionllm_tpu_torch.config import vllm_26b_det_config
    from visionllm_tpu_torch.models.composite import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(vllm_26b_det_config())


def test_26b_det_model_is_laid_out_on_meta():
    """The full-width 26B det model as `build_model` lays it out before it
    moves to the card: every parameter on the meta device (no host
    memory), about 27 B of them, the parts as the JAX config sizes them,
    and bf16 after the cast, so the card holds about 54 GB."""
    from visionllm_tpu_torch.config import vllm_26b_det_config
    from visionllm_tpu_torch.models.composite import VisionLLMWithTools
    cfg = vllm_26b_det_config()
    with torch.device("meta"):
        model = VisionLLMWithTools(cfg).to(dtype=torch.bfloat16)
    params = list(model.parameters())
    assert all(p.is_meta and p.dtype == torch.bfloat16 for p in params)

    def count(mod):
        return sum(p.numel() for p in mod.parameters())

    core = model.core
    assert count(core.vis_encoder) == 5_905_251_200
    assert count(core.vl_bridge) == 116_429_824
    assert count(core.llm) == 19_861_542_912
    assert 0.9e9 < count(model.gdino) < 1.2e9
    assert tuple(core.vl_bridge._modules["1"].weight.shape) == (6144, 12800)
    assert tuple(core.llm.layers[0].k_proj.weight.shape) == (1024, 6144)
    assert 26.9e9 < count(model) < 27.2e9


def test_gen_modules_are_among_the_guarded_sources():
    """The import guard above walks the whole package: the generation
    heads' modules are in it."""
    paths = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for name in ("__init__", "scheduler", "unet", "vae", "sd_head"):
        assert (f"visionllm_tpu_torch/models/stable_diffusion/{name}.py"
                in paths)
    assert "visionllm_tpu_torch/tools/sd_layout_probe.py" in paths


def test_layout_probe_builds_as_build_model_and_needs_a_card():
    """The layout probe builds its modules as `build_model` does (bf16,
    the norms fp32, the conv weights in `MAP_FORMAT`) and runs on the
    card only."""
    from visionllm_tpu_torch.models.stable_diffusion import unet as SDU
    from visionllm_tpu_torch.models.stable_diffusion.sd_head import (
        unet_cfg_for)
    from visionllm_tpu_torch.tools import sd_layout_probe as probe
    unet = probe.build(lambda: SDU.UNet2DCondition(unet_cfg_for(16, 8, 32)),
                       torch.device("cpu"))
    for m in unet.modules():
        want = (torch.float32 if isinstance(m, (SDU.GroupNorm32,
                                                SDU.LayerNorm))
                else torch.bfloat16)
        assert all(p.dtype == want for p in m.parameters(recurse=False))
    assert unet.conv_in.weight.is_contiguous(memory_format=SDU.MAP_FORMAT)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            probe.main()


def test_gen_entry_point_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from visionllm_tpu_torch.config import vllm_7b_gen_config
    from visionllm_tpu_torch.models.composite import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(vllm_7b_gen_config())


def test_region_modules_are_among_the_guarded_sources():
    """The import guard above walks the whole package: the region
    encoder and the region-eval helpers are in it."""
    paths = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("visionllm_tpu_torch/models/region_encoder.py",
                "visionllm_tpu_torch/eval/region_eval.py"):
        assert rel in paths


def test_whole_7b_entry_point_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from visionllm_tpu_torch.config import vllm_7b_config
    from visionllm_tpu_torch.models.composite import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(vllm_7b_config())


def _config_diff(got, want, path=""):
    """Field paths where two config dataclasses differ (the port's fields
    against the JAX one's of the same name)."""
    import dataclasses
    out = []
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
            out += _config_diff(a, b, f"{path}{f.name}.")
        elif a != b:
            out.append((path + f.name, a, b))
    return out


def test_whole_7b_config_matches_jax_field_for_field():
    """`vllm_7b_config()` against the JAX preset: no field of the port's
    (nested configs included) differs, and every tool the JAX preset
    turns on is on."""
    import dataclasses
    from visionllm_tpu import config as jconfig
    from visionllm_tpu_torch.config import vllm_7b_config
    got, want = vllm_7b_config(), jconfig.vllm_7b_config()
    assert _config_diff(got, want) == []
    for name in ("region_encoder", "unipose", "sd", "ip2p"):
        assert ({f.name for f in dataclasses.fields(getattr(got, name))}
                == {f.name for f in dataclasses.fields(getattr(want, name))})
    assert all(getattr(got, f"use_{t}") for t in
               ("gdino", "unipose", "sd", "ip2p", "region_encoder"))


def test_whole_7b_model_is_laid_out_on_meta():
    """`vllm_7b_config()` as `build_model` lays it out before it moves to
    the card: every tool and the region encoder, about 9.13 B parameters
    (the gen config's 8.99 B, Grounding-DINO and UniPose at about 65 M
    each and 4.5 M of region encoder), bf16 but for the fp32 parts."""
    from visionllm_tpu_torch.config import vllm_7b_config
    from visionllm_tpu_torch.models.composite import VisionLLMWithTools
    from visionllm_tpu_torch.models.region_encoder import LayerNorm2d
    with torch.device("meta"):
        model = VisionLLMWithTools(vllm_7b_config()).to(dtype=torch.bfloat16)
        for mod in model.fp32_modules():
            mod.float()
    enc = model.core.region_encoder
    assert enc is not None and model.gdino is not None
    assert model.unipose is not None and model.sd is not None
    norms = [m for m in enc.modules() if isinstance(m, LayerNorm2d)]
    assert len(norms) == 2 and all(
        p.dtype == torch.float32 for m in norms for p in m.parameters())
    assert enc.stem_conv0.weight.dtype == torch.bfloat16
    n = sum(p.numel() for p in model.parameters())
    assert 9.1e9 < n < 9.15e9, n


def test_whole_26b_modules_are_among_the_guarded_sources():
    """The import guard above walks the whole package: the backbone
    choice shared by Grounding-DINO and UniPose is in it."""
    paths = {os.path.relpath(p, ROOT) for p in _port_sources()}
    for rel in ("visionllm_tpu_torch/models/backbone.py",
                "visionllm_tpu_torch/models/swin.py",
                "visionllm_tpu_torch/models/unipose/model.py",
                "visionllm_tpu_torch/models/grounding_dino/model.py",
                "visionllm_tpu_torch/models/composite.py",
                "visionllm_tpu_torch/config.py"):
        assert rel in paths


def test_whole_26b_entry_point_without_device_raises_on_cpu_host():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from visionllm_tpu_torch.config import vllm_26b_config
    from visionllm_tpu_torch.models.composite import build_model
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(vllm_26b_config())


def test_whole_26b_model_is_laid_out_on_meta():
    """`vllm_26b_config()` as `build_model` lays it out before it moves to
    the card: the det path's 27.0 B parameters, UniPose on InternImage-H
    (about 1.11 B, its backbone about 1.07 B), the two heads at about
    0.97 B each and 20.6 M of region encoder (3200 -> 6144); bf16 but for
    the fp32 parts, about 60.2 GB in all. (`model_size`, the host-only
    count, is held to JAX's tree in `test_torch_internvl.py`.)"""
    from visionllm_tpu_torch.config import vllm_26b_config
    from visionllm_tpu_torch.models.composite import _meta_model
    model = _meta_model(vllm_26b_config(), torch.bfloat16)

    def count(mod):
        return sum(p.numel() for p in mod.parameters())

    assert 1.10e9 < count(model.unipose) < 1.12e9
    assert 1.06e9 < count(model.unipose.backbone) < 1.08e9
    assert 0.96e9 < count(model.sd) < 0.97e9
    assert 0.96e9 < count(model.ip2p) < 0.97e9
    assert 20e6 < count(model.core.region_encoder) < 21e6
    assert tuple(model.sd.mapper.emb_proj_0.weight.shape) == (768, 6144)
    assert model.sd.mapper.emb_proj_0.weight.dtype == torch.float32
    assert model.unipose.input_proj_2.weight.dtype == torch.bfloat16
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    assert 60.1e9 < nbytes < 60.3e9
