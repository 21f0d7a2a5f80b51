"""paddle_tpu_torch: the PyTorch/CUDA port of `paddle_tpu`.

The package mirrors `paddle_tpu`'s module paths (`serving/engine.py`,
`models/llama.py`, `kernels/paged_attention.py`, ...) so each module's
counterpart is found by name. It imports torch and numpy only: every
Pallas kernel of a ported path is a hand-written Hopper kernel under
`kernels/csrc/`, built at first use, and the plain PyTorch version
beside it serves CPU tensors (the tests) and the on-card comparison.

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; asking for the card when none is present raises.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
