"""Config dataclasses of the det, perception, chat, generation, region
and training paths (own copies of the JAX package's
`VisionEncoderConfig`, `LLMConfig`, `GDinoConfig`, `UniPoseConfig`,
`SDConfig`, `IP2PConfig`, `RegionEncoderConfig`, `VisionLLMConfig`,
`tiny_test_config` and, from `visionllm_tpu/train/train_step.py`,
`OptimizerConfig`, cut to the fields this port reads; defaults and the
tiny dims are the same), and the flagship configs of the paths ported:
the whole 7B flagship (`vllm_7b_config`), its det, perception, chat and
generation cuts, and the 26B det config. LoRA (`LLMConfig.lora_r`),
rematerialization (`LLMConfig.remat`, `GDinoConfig.remat`) and gradient
accumulation (`OptimizerConfig.grad_accum_steps`) are ported."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Tuple


REMAT_MODES = ("", "dots", "full")


def _check_remat(owner: str, remat: str) -> None:
    if remat not in REMAT_MODES:
        raise ValueError(f"{owner}.remat={remat!r}: one of '', 'dots', "
                         "'full'")


@dataclass(frozen=True)
class VisionEncoderConfig:
    """CLIP-ViT-L/336 by default; InternViT-6B with arch="intern_vit"."""

    arch: str = "clip_vit"            # "clip_vit" | "intern_vit"
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    intermediate_size: int = 4096
    num_layers: int = 24
    num_heads: int = 16
    layer_norm_eps: float = 1e-5
    hidden_act: str = "quick_gelu"
    # InternViT: RMSNorm of the concatenated q and k, layer scale, and
    # whether the fused qkv projection has a bias
    qk_normalization: bool = False
    use_ls: bool = False
    qkv_bias: bool = True
    # which hidden_states layer feeds the VL bridge (reference default -2)
    output_layer: int = -2

    def __post_init__(self):
        if self.arch not in ("clip_vit", "intern_vit"):
            raise NotImplementedError(f"vision encoder {self.arch!r}")

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


@dataclass(frozen=True)
class LLMConfig:
    """LLaMA-family decoder (Vicuna-7B default); InternLM2 with
    arch="internlm2" runs the same decoder (the JAX `llama.py` does not
    branch on it: InternLM2's packed `wqkv` exists only in the weight
    converter)."""

    arch: str = "llama"               # "llama" | "internlm2"
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096
    # LoRA on the seven projections of every layer (q/k/v/o, gate/up/
    # down; `models/lora.py`): rank 0 is off; the reference's r 32 and
    # alpha 64. It takes priority over `quant` in the layers
    lora_r: int = 0
    lora_alpha: float = 64.0
    # serving-only weight storage: "" (model dtype) | "int8" (w8a16,
    # per-channel scales) | "w8a8" (int8 weights and dynamic int8
    # activations, ops/quant.py) | "int4" (w4a16 group-128 packed
    # nibbles, ops/quant4.py)
    quant: str = ""
    # serving-only KV-cache storage: "" (model dtype) | "int8" (int8 K/V
    # with per-(token, head) bf16 scales)
    kv_quant: str = ""
    # training-time rematerialization of each decoder layer: "" (store
    # all activations) | "dots" (save the outputs of the 2-D products,
    # recompute the rest) | "full" (recompute the layer in the backward)
    remat: str = ""

    def __post_init__(self):
        _check_remat("LLMConfig", self.remat)
        if self.arch not in ("llama", "internlm2"):
            raise NotImplementedError(f"LLM {self.arch!r}")
        if self.quant not in ("", "int8", "w8a8", "int4"):
            raise ValueError(f"LLMConfig.quant={self.quant!r}: one of '', "
                             "'int8', 'w8a8', 'int4'")
        if self.kv_quant not in ("", "int8"):
            raise ValueError(f"LLMConfig.kv_quant={self.kv_quant!r}: one "
                             "of '', 'int8'")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class GDinoConfig:
    """Open-vocabulary Grounding-DINO decoder and its training losses."""

    # "swin_tiny" | "swin_large" | "intern_image_h" | "intern_image_tiny"
    # (the JAX package's test backbone: InternImage with depths
    # (1, 1, 1, 1)); `models/backbone.py`
    backbone: str = "swin_tiny"
    # optional kwargs overriding the swin preset's dims; None -> preset
    backbone_overrides: Optional[Mapping[str, Any]] = None
    d_model: int = 256
    num_queries: int = 900
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    num_feature_levels: int = 4
    num_points: int = 4
    ffn_dim: int = 2048
    text_dim: int = 4096
    max_text_len: int = 256
    mask_dim: int = 256
    two_stage: bool = True
    # losses: matcher costs and loss weights
    class_cost: float = 2.0
    bbox_cost: float = 5.0
    giou_cost: float = 2.0
    class_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    mask_loss_coef: float = 5.0
    dice_loss_coef: float = 5.0
    focal_alpha: float = 0.25
    # contrastive denoising
    dn_number: int = 100
    label_noise_ratio: float = 0.5
    box_noise_scale: float = 1.0
    # mask point sampling (Mask2Former-style)
    num_mask_points: int = 12544
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    # rematerialization of each encoder and decoder layer: "" (store all
    # activations) | "dots" (save the outputs of every product, batched
    # ones too) | "full" (recompute the layer in the backward)
    remat: str = ""

    def __post_init__(self):
        _check_remat("GDinoConfig", self.remat)


@dataclass(frozen=True)
class UniPoseConfig:
    """UniPose keypoint decoder."""

    # the backbones of `GDinoConfig.backbone`, at their presets
    backbone: str = "swin_tiny"
    d_model: int = 256
    num_queries: int = 900
    encoder_layers: int = 6
    decoder_layers: int = 6
    num_heads: int = 8
    num_feature_levels: int = 4
    num_points: int = 4
    ffn_dim: int = 2048
    text_dim: int = 4096
    num_box_decoder_layers: int = 2
    num_body_points: int = 68         # max keypoints per instance
    num_groups: int = 50              # pose groups after box->kpt expansion
    # vision sine-position-embedding temperature (the DINO-family 20)
    pe_temperature: float = 20.0
    max_obj_patches: int = 100
    max_kpt_patches: int = 100
    # losses
    class_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    keypoint_loss_coef: float = 10.0
    oks_loss_coef: float = 4.0
    focal_alpha: float = 0.25
    aux_loss: bool = True
    dn_number: int = 100


@dataclass(frozen=True)
class SDConfig:
    """Stable-Diffusion-1.5 generation head driven by [GEN] embeddings."""

    llm_hidden_size: int = 4096
    sd_hidden_size: int = 768         # CLIP text embedding dim of SD-1.5
    num_encoder_layers: int = 1
    num_decoder_layers: int = 1
    num_queries: int = 77
    num_embs_gen: int = 64
    caption_distill_weight: float = 0.1
    # UNet / VAE geometry (SD-1.5)
    sample_size: int = 64
    in_channels: int = 4
    cross_attention_dim: int = 768


@dataclass(frozen=True)
class IP2PConfig:
    """InstructPix2Pix editing head driven by [EDIT] embeddings."""

    llm_hidden_size: int = 4096
    sd_hidden_size: int = 768
    num_encoder_layers: int = 1
    num_decoder_layers: int = 1
    num_queries: int = 77
    num_embs_gen: int = 64
    # UNet input = concat(noisy latents, conditioning image latents)
    in_channels: int = 8
    sample_size: int = 64
    cross_attention_dim: int = 768
    cfg_drop_prob: float = 0.05


@dataclass(frozen=True)
class RegionEncoderConfig:
    """The visual-prompt encoder: a mask and its image to one LLM token
    (`models/region_encoder.py`)."""

    hidden_dim: int = 256
    embed_dim: int = 1024             # ViT feature dim
    out_dim: int = 4096               # LLM dim
    patch_size: int = 14
    # the reference's random-point count; the closed-form pooling reads
    # no points, so only the JAX training data reads it
    num_sample_points: int = 2304


@dataclass(frozen=True)
class VisionLLMConfig:
    """Top-level composition config of the det, perception, chat,
    generation and region paths."""

    vis_encoder: VisionEncoderConfig = field(default_factory=VisionEncoderConfig)
    llm: LLMConfig = field(default_factory=LLMConfig)
    vl_bridge_type: str = "mlp2x_gelu"  # "linear" | "internvl_mlp" | "mlpNx_gelu"
    # pixel shuffle at 0.5 before the bridge: a quarter of the tokens,
    # four times the width
    use_pixelshuffle: bool = False
    num_embs: int = 4
    num_embs_gen: int = 64
    use_region_encoder: bool = False
    region_encoder: Optional[RegionEncoderConfig] = None
    use_gdino: bool = False
    gdino: Optional[GDinoConfig] = None
    use_unipose: bool = False
    unipose: Optional[UniPoseConfig] = None
    use_sd: bool = False
    sd: Optional[SDConfig] = None
    use_ip2p: bool = False
    ip2p: Optional[IP2PConfig] = None
    max_num_patches: int = 100

    @property
    def image_token_len(self) -> int:
        """<im_patch> tokens an image (a tile) fills: the vision
        encoder's patches, a quarter of them under pixel shuffle (the
        count of the JAX dataset, `llava_dataset.py:80-82`)."""
        n = self.vis_encoder.num_patches
        return n // 4 if self.use_pixelshuffle else n

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "VisionLLMConfig":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, raw: Mapping[str, Any]) -> "VisionLLMConfig":
        """The config of a dict such as `to_json` writes, or the JAX
        package's `to_json`: the fields of it that no module of either
        package reads (`JAX_ONLY_FIELDS`) are dropped."""
        def build(klass, val):
            if val is None:
                return None
            val = dict(val)
            for name in JAX_ONLY_FIELDS.get(klass.__name__, ()):
                val.pop(name, None)
            return klass(**val)

        kwargs = dict(raw)
        for name in JAX_ONLY_FIELDS["VisionLLMConfig"]:
            kwargs.pop(name, None)
        kwargs["vis_encoder"] = (build(VisionEncoderConfig,
                                       raw.get("vis_encoder"))
                                 or VisionEncoderConfig())
        kwargs["llm"] = build(LLMConfig, raw.get("llm")) or LLMConfig()
        for name, klass in (("region_encoder", RegionEncoderConfig),
                            ("gdino", GDinoConfig),
                            ("unipose", UniPoseConfig), ("sd", SDConfig),
                            ("ip2p", IP2PConfig)):
            kwargs[name] = build(klass, raw.get(name))
        return cls(**kwargs)


# fields of the JAX package's configs that its `to_json` writes and no
# module of either package reads
JAX_ONLY_FIELDS = {"VisionLLMConfig": ("param_dtype", "compute_dtype"),
                   "GDinoConfig": ("aux_loss",)}


def vllm_7b_config(**overrides: Any) -> VisionLLMConfig:
    """The whole 7B flagship, the JAX `vllm_7b_config()` field for field:
    `vllm_7b_gen_config()` (CLIP-ViT-L/336 + `mlp2x_gelu` + Vicuna-7B
    vocab 32096 + the [GEN] and [EDIT] heads) with these on as well:
    `use_gdino` with `GDinoConfig()` (Grounding-DINO on Swin-T),
    `use_unipose` with `UniPoseConfig()` (UniPose on Swin-T) and
    `use_region_encoder` with `RegionEncoderConfig()` (hidden 256, CLIP's
    1024 features to the LLM's 4096, patch 14)."""
    base = dict(
        vis_encoder=VisionEncoderConfig(),
        llm=LLMConfig(vocab_size=32096),
        vl_bridge_type="mlp2x_gelu",
        use_gdino=True,
        gdino=GDinoConfig(),
        use_unipose=True,
        unipose=UniPoseConfig(),
        use_sd=True,
        sd=SDConfig(),
        use_ip2p=True,
        ip2p=IP2PConfig(),
        use_region_encoder=True,
        region_encoder=RegionEncoderConfig(),
    )
    base.update(overrides)
    return VisionLLMConfig(**base)


def vllm_7b_det_config(**overrides: Any) -> VisionLLMConfig:
    """The 7B flagship's det path: CLIP-ViT-L/336 + Vicuna-7B (vocab
    32096) + Grounding-DINO with Swin-T at its defaults."""
    base = dict(
        vis_encoder=VisionEncoderConfig(),
        llm=LLMConfig(vocab_size=32096),
        vl_bridge_type="mlp2x_gelu",
        use_gdino=True,
        gdino=GDinoConfig(),
    )
    base.update(overrides)
    return VisionLLMConfig(**base)


def vllm_7b_perception_config(**overrides: Any) -> VisionLLMConfig:
    """The 7B flagship's perception tools: the JAX `vllm_7b_config(
    use_sd=False, use_ip2p=False, use_region_encoder=False)`, field for
    field: CLIP-ViT-L/336 + `mlp2x_gelu` + Vicuna-7B (vocab 32096) +
    Grounding-DINO and UniPose, each with Swin-T at its defaults (the
    generation heads' and the region encoder's configs are carried, as
    JAX carries them, and off)."""
    base = dict(
        vis_encoder=VisionEncoderConfig(),
        llm=LLMConfig(vocab_size=32096),
        vl_bridge_type="mlp2x_gelu",
        use_gdino=True,
        gdino=GDinoConfig(),
        use_unipose=True,
        unipose=UniPoseConfig(),
        sd=SDConfig(),
        ip2p=IP2PConfig(),
        region_encoder=RegionEncoderConfig(),
    )
    base.update(overrides)
    return VisionLLMConfig(**base)


def vllm_7b_chat_config(**overrides: Any) -> VisionLLMConfig:
    """The 7B flagship's chat path: the JAX `vllm_7b_config` with the tool
    decoders off (chat needs none): CLIP-ViT-L/336 + `mlp2x_gelu` +
    Vicuna-7B (vocab 32096). Pass `llm=LLMConfig(vocab_size=32096,
    quant="int4")` (or "int8", "w8a8"; `kv_quant="int8"`) for the
    quantized serving modes."""
    base = dict(
        vis_encoder=VisionEncoderConfig(),
        llm=LLMConfig(vocab_size=32096),
        vl_bridge_type="mlp2x_gelu",
    )
    base.update(overrides)
    return VisionLLMConfig(**base)


def vllm_7b_gen_config(**overrides: Any) -> VisionLLMConfig:
    """The 7B flagship's generation tools: the JAX `vllm_7b_config(
    use_gdino=False, use_unipose=False, use_region_encoder=False)`, field
    for field: CLIP-ViT-L/336 + `mlp2x_gelu` + Vicuna-7B (vocab 32096) +
    the [GEN] head (`SDConfig()`: the LLM2SD mapper 4096 -> 768 with 77
    queries, the SD-1.5 UNet with 4 input channels and its VAE at 512 px,
    `sample_size` 64) and the [EDIT] head (`IP2PConfig()`: the same with
    8 UNet input channels); the Grounding-DINO, UniPose and region
    encoder configs are carried, as JAX carries them, and off."""
    base = dict(
        vis_encoder=VisionEncoderConfig(),
        llm=LLMConfig(vocab_size=32096),
        vl_bridge_type="mlp2x_gelu",
        gdino=GDinoConfig(),
        unipose=UniPoseConfig(),
        region_encoder=RegionEncoderConfig(),
        use_sd=True,
        sd=SDConfig(),
        use_ip2p=True,
        ip2p=IP2PConfig(),
    )
    base.update(overrides)
    return VisionLLMConfig(**base)


def vllm_26b_config(**overrides: Any) -> VisionLLMConfig:
    """The whole 26B flagship, the JAX `vllm_26b_config()` field for
    field: InternViT-6B/448 (48 layers, 25 heads, QK-norm, layer scale,
    no qkv bias, the last layer), pixel shuffle and the `internvl_mlp`
    bridge, InternLM2-20B (vocab 92576, 48 layers, 48 heads over 8 KV
    heads, rope theta 1e6), Grounding-DINO and UniPose on InternImage-H
    with text_dim 6144, the [GEN] and [EDIT] heads at `llm_hidden_size`
    6144, and the region encoder from InternViT's 3200 features to the
    LLM's 6144."""
    base = dict(
        vis_encoder=VisionEncoderConfig(
            arch="intern_vit", image_size=448, patch_size=14,
            hidden_size=3200, intermediate_size=12800, num_layers=48,
            num_heads=25, layer_norm_eps=1e-6, hidden_act="gelu",
            qk_normalization=True, use_ls=True, qkv_bias=False,
            output_layer=-1),
        llm=LLMConfig(
            arch="internlm2", vocab_size=92576, hidden_size=6144,
            intermediate_size=16384, num_layers=48, num_heads=48,
            num_kv_heads=8, rope_theta=1000000.0,
            max_position_embeddings=32768),
        vl_bridge_type="internvl_mlp",
        use_pixelshuffle=True,
        use_gdino=True,
        gdino=GDinoConfig(backbone="intern_image_h", text_dim=6144),
        use_unipose=True,
        unipose=UniPoseConfig(backbone="intern_image_h", text_dim=6144),
        use_sd=True,
        sd=SDConfig(llm_hidden_size=6144),
        use_ip2p=True,
        ip2p=IP2PConfig(llm_hidden_size=6144),
        use_region_encoder=True,
        region_encoder=RegionEncoderConfig(embed_dim=3200, out_dim=6144),
    )
    base.update(overrides)
    return VisionLLMConfig(**base)


def vllm_26b_det_config(**overrides: Any) -> VisionLLMConfig:
    """The 26B flagship's det path: `vllm_26b_config(use_unipose=False,
    use_sd=False, use_ip2p=False, use_region_encoder=False)` (InternViT-6B,
    InternLM2-20B and Grounding-DINO on InternImage-H; the other tools'
    configs carried, as JAX carries them, and off)."""
    base = dict(use_unipose=False, use_sd=False, use_ip2p=False,
                use_region_encoder=False)
    base.update(overrides)
    return vllm_26b_config(**base)


def tiny_test_config(**overrides: Any) -> VisionLLMConfig:
    """A minuscule config for unit tests (same dims as the JAX package's
    `tiny_test_config` for the fields kept here). The region encoder's
    tiny config is carried and off: the parity tests load JAX trees
    without `region_encoder` keys, and turn it on as an override."""
    base = dict(
        vis_encoder=VisionEncoderConfig(
            image_size=56, patch_size=14, hidden_size=32, intermediate_size=64,
            num_layers=2, num_heads=4),
        llm=LLMConfig(
            vocab_size=32096, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=4,
            max_position_embeddings=512),
        vl_bridge_type="mlp2x_gelu",
        use_gdino=True,
        gdino=GDinoConfig(
            d_model=32, num_queries=20, encoder_layers=1, decoder_layers=2,
            num_heads=4, ffn_dim=64, text_dim=64, mask_dim=32, dn_number=4,
            num_mask_points=64),
        use_unipose=True,
        unipose=UniPoseConfig(
            d_model=32, num_queries=20, encoder_layers=1, decoder_layers=3,
            num_heads=4, ffn_dim=64, text_dim=64, num_body_points=4,
            num_groups=5, max_obj_patches=8, max_kpt_patches=8),
        region_encoder=RegionEncoderConfig(
            hidden_dim=16, embed_dim=32, out_dim=64, patch_size=14,
            num_sample_points=32),
        num_embs_gen=8,
        max_num_patches=10,
    )
    base.update(overrides)
    return VisionLLMConfig(**base)


@dataclass(frozen=True)
class OptimizerConfig:
    """AdamW with per-group lr multipliers (the JAX `OptimizerConfig`)."""

    learning_rate: float = 2e-5
    lr_multiplier: float = 0.1        # backbone / sampling_offsets / ref pts
    lr_llm_multiplier: float = 1.0    # llm / region_encoder / vl_bridge
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    max_grad_norm: float = 1.0
    warmup_steps: int = 0
    total_steps: int = 10_000
    schedule: str = "cosine"          # "cosine" | "constant"
    # micro-batches per optimizer step: the running mean of their
    # gradients is applied once every k (optax.MultiSteps)
    grad_accum_steps: int = 1

    def __post_init__(self):
        if self.grad_accum_steps < 1:
            raise ValueError(
                f"OptimizerConfig.grad_accum_steps={self.grad_accum_steps}: "
                "at least 1")
        if self.schedule not in ("cosine", "constant"):
            raise ValueError(f"unknown schedule {self.schedule!r}")
