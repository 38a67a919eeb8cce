"""Rematerialization of one layer in the backward pass (counterpart of
flax's `nn.remat` with JAX's checkpoint policies).

`remat_call(mode, saved_ops, fn, *args, **kwargs)` runs `fn` under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)` when `mode` is
"dots" or "full" and autograd records: "full" keeps only the layer's
inputs and recomputes the whole layer in the backward; "dots" also keeps
the outputs of the operators in `saved_ops` (a selective-checkpoint
policy) and recomputes the rest. The kernels of `ops/` run inside their
own autograd functions through ctypes, which the dispatcher does not see,
so both modes launch them again in the backward, as JAX reruns a Pallas
call under `jax.checkpoint`. The layers draw no random numbers, so no RNG
state is stashed.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

aten = torch.ops.aten
# JAX `dots_with_no_batch_dims_saveable`: the 2-D products (an nn.Linear
# on any leading shape is one of these)
NO_BATCH_DOTS = (aten.mm.default, aten.addmm.default)
# JAX `checkpoint_dots`: every product, batched ones too
ALL_DOTS = NO_BATCH_DOTS + (aten.bmm.default, aten.baddbmm.default)


def _policy(saved_ops):
    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in saved_ops
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return policy


def remat_call(mode: str, saved_ops, fn, *args, **kwargs):
    """`fn(*args, **kwargs)`, rematerialized per `mode` ("" runs it
    plainly; so does any mode while autograd is not recording)."""
    if not mode or not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    extra = {}
    if mode == "dots":
        extra["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _policy(saved_ops))
    elif mode != "full":
        raise ValueError(f"remat={mode!r}: one of '', 'dots', 'full'")
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **extra, **kwargs)
