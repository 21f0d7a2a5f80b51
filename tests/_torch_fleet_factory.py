"""Worker model factory of `tests/test_torch_fleet_proc.py`: the port's
Llama built from the reference's exported weights, an .npz the test
writes, so a worker process holds the weights the reference engine
serves. Imports no JAX (worker processes never load it)."""
import numpy as np
import torch

from paddle_tpu_torch.models.convert import from_jax_state_dict
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM


def llama_from_npz(path, config, device="cpu"):
    cfg = LlamaConfig(**config)
    with np.load(path) as z:
        state = {k: z[k] for k in z.files}
    model = LlamaForCausalLM(cfg, device=device,
                             generator=torch.Generator(device)
                             .manual_seed(0))
    model.load_state_dict(from_jax_state_dict(state, cfg), strict=True)
    return model
