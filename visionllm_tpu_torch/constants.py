"""Special tokens and tool kinds of the super-link routing protocol (copy
of the JAX package's `constants.py` values that the det, perception and
chat paths use). The token strings must match the reference checkpoint's."""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200

# all special tokens added to the tokenizer, in the reference's order
DEFAULT_TOKENS = {
    "pad": "[PAD]",
    "bos": "<s>",
    "eos": "</s>",
    "unk": "<unk>",
    "img": "<image>",
    "imp": "<im_patch>",
    "reg": "<region>",
    "boi": "<img>",
    "eoi": "</img>",
    "sor": "<reg>",
    "eor": "</reg>",
    "sod": "<det>",
    "eod": "</det>",
    "sog": "<grd>",
    "eog": "</grd>",
    "det": "[DET]",
    "grd": "[GRD]",
    "seg": "[SEG]",
    "pose": "[POSE]",
    "gen": "[GEN]",
    "edit": "[EDIT]",
    "emb": "[EMB]",
    "emb2": "[EMB2]",
    "emb3": "[EMB3]",
    "emb4": "[EMB4]",
    "emb5": "[EMB5]",
    "emb6": "[EMB6]",
    "emb7": "[EMB7]",
    "emb8": "[EMB8]",
}

TOOL_NONE = 0
TOOL_DET = 1   # [DET]/[SEG]/[GRD] -> grounding-dino
TOOL_POSE = 2  # [POSE]           -> unipose
TOOL_GEN = 3   # [GEN]            -> stable-diffusion
TOOL_EDIT = 4  # [EDIT]           -> instruct-pix2pix
