"""fleet.utils.recompute (port of
`paddle_tpu/distributed/fleet/utils/__init__.py`): activation
checkpointing as non-reentrant `torch.utils.checkpoint`. The forward
keeps only the function's inputs; the backward replays the function
(its kernels included) and differentiates the replay, so a module's
parameters get their gradients as without recompute.

`offload=` and `policy=` are the reference's TPU remat policies (saved
matmul residuals in pinned host memory, a `jax.checkpoint_policies`
entry): not ported, they raise. Not ported either: the reference's
`recompute_sequential`, `recompute_hybrid`, `LocalFS`, `HDFSClient` and
`DistributedInfer`.
"""
from __future__ import annotations

import torch.utils.checkpoint

__all__ = ["recompute"]


def recompute(function, *args, **kwargs):
    """function(*args, **kwargs), its activations recomputed in the
    backward. `use_reentrant` is accepted and ignored (the replay is
    always non-reentrant); `preserve_rng_state` (default True) replays
    the forward's random draws."""
    kwargs.pop("use_reentrant", None)
    preserve = kwargs.pop("preserve_rng_state", True)
    for opt in ("offload", "policy"):
        if kwargs.pop(opt, None):
            raise NotImplementedError(
                f"recompute({opt}=...) is a TPU remat policy and is not "
                "ported to paddle_tpu_torch (see ROADMAP.md)")
    return torch.utils.checkpoint.checkpoint(
        function, *args, use_reentrant=False,
        preserve_rng_state=preserve, **kwargs)
