"""The parallel layer: process groups, the device mesh and its sharding
rules, multi-process eval helpers, sequence constraints and the GPipe
pipeline (counterpart of `visionllm_tpu/parallel/`)."""

from visionllm_tpu_torch.parallel.mesh import (MeshRules, apply_shardings,
                                               apply_tensor_parallel,
                                               build_mesh,
                                               init_process_group_for,
                                               shard_batch, shard_params)
from visionllm_tpu_torch.parallel.sequence import constrain_seq, set_mesh
