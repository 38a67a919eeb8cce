"""Tool kinds of the super-link routing protocol (copy of the JAX
package's `constants.py` values that the det path uses)."""

TOOL_NONE = 0
TOOL_DET = 1   # [DET]/[SEG]/[GRD] -> grounding-dino
TOOL_POSE = 2  # [POSE]           -> unipose
TOOL_GEN = 3   # [GEN]            -> stable-diffusion
TOOL_EDIT = 4  # [EDIT]           -> instruct-pix2pix
