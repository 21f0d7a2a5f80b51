"""The PyTorch port stands alone: importing every module of
`paddle_tpu_torch` (and the root scripts `chip_smoke.py` and
`chip_fault_check.py`) pulls in neither JAX nor
anything of `paddle_tpu`, and no source file of either imports them."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_fault_check.py"]

_PROBE = r"""
import importlib, pkgutil, sys
import paddle_tpu_torch
for m in pkgutil.walk_packages(paddle_tpu_torch.__path__, "paddle_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke, chip_fault_check
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith("jax.") or n == "jaxlib"
             or n == "paddle_tpu" or n.startswith("paddle_tpu."))
print("LEAKED", bad)
sys.exit(1 if bad else 0)
"""


def test_import_leaves_jax_and_reference_out():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _forbidden(name: str) -> bool:
    return (name in ("jax", "jaxlib", "paddle_tpu")
            or name.startswith(("jax.", "jaxlib.", "paddle_tpu.")))


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_reference(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), \
            f"{path.relative_to(ROOT)}:{node.lineno} imports {names}"


def test_walk_reaches_the_quantized_serving_modules():
    """The probe above imports every module the package walk finds; the
    quantized-serving ones are among them."""
    import pkgutil

    import paddle_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                                   "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.nn.quant",
            "paddle_tpu_torch.kernels.quant_matmul",
            "paddle_tpu_torch.kernels.paged_attention"} <= names


def test_walk_reaches_the_lora_modules():
    """The multi-LoRA modules are among those the probe imports."""
    import pkgutil

    import paddle_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                                   "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.serving.lora",
            "paddle_tpu_torch.serving.lora.adapter",
            "paddle_tpu_torch.serving.lora.store",
            "paddle_tpu_torch.serving.lora.runtime",
            "paddle_tpu_torch.kernels.lora_matmul"} <= names


def test_walk_reaches_the_packed_attention_and_norm_modules():
    """The varlen/flashmask attention and RMSNorm-rows modules are among
    those the probe imports (so none of them pulls in JAX)."""
    import pkgutil

    import paddle_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                                   "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.kernels.flash_attention",
            "paddle_tpu_torch.kernels.fused_norm",
            "paddle_tpu_torch.nn.functional.flash_attention",
            "paddle_tpu_torch.nn.functional.extra"} <= names


def test_walk_reaches_the_fleet_modules():
    """The in-process and cross-process fleet and the exposition module
    are among those the probe imports."""
    import pkgutil

    import paddle_tpu_torch
    names = {m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                                   "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.serving.fleet",
            "paddle_tpu_torch.serving.fleet.fleet",
            "paddle_tpu_torch.serving.fleet.replica",
            "paddle_tpu_torch.serving.fleet.router",
            "paddle_tpu_torch.serving.fleet.server",
            "paddle_tpu_torch.serving.fleet.http",
            "paddle_tpu_torch.serving.fleet.procfleet",
            "paddle_tpu_torch.serving.fleet.worker",
            "paddle_tpu_torch.serving.fleet.transport",
            "paddle_tpu_torch.profiler.exposition"} <= names


def test_walk_reaches_the_moe_modules():
    """The MoE routing and the Qwen2-MoE model are among the modules the
    probe imports, and the port's `models` exports the reference's four
    Qwen2-MoE names; the MoE module exports the reference's names less
    the expert-parallel collectives."""
    import pkgutil

    import paddle_tpu.distributed.moe as ref_moe
    import paddle_tpu_torch
    import paddle_tpu_torch.models as models
    from paddle_tpu_torch.distributed import moe
    names = {m.name for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                                   "paddle_tpu_torch.")}
    assert {"paddle_tpu_torch.distributed.moe",
            "paddle_tpu_torch.models.qwen2_moe"} <= names
    assert {"Qwen2MoeConfig", "Qwen2MoeForCausalLM", "qwen2_moe_tiny",
            "qwen2_moe_a14b"} <= set(models.__all__)
    assert set(ref_moe.__all__) - set(moe.__all__) == {"global_scatter",
                                                       "global_gather"}


def test_the_tensor_parallel_names_are_ported():
    """The launcher, the mpu layers and `ParallelCrossEntropy`, the TP
    mesh and the TP paged decode exist under the reference's names; of
    the reference's mpu module only the RNG tracker and the mesh helpers
    are missing (`paddle_tpu.distributed` and its
    `fleet` declare no `__all__`, so the walk below does not see them)."""
    import paddle_tpu.distributed.fleet.mpu as ref_mpu
    import paddle_tpu_torch.distributed as dist
    from paddle_tpu_torch.distributed.fleet import mpu
    from paddle_tpu_torch.kernels import paged_attention
    from paddle_tpu_torch.serving import tp_serving_mesh  # noqa: F401
    for name in ("init_parallel_env", "get_rank", "get_world_size",
                 "spawn"):
        assert name in dist.__all__
    assert "paged_attention_decode_tp" in paged_attention.__all__
    missing = set(ref_mpu.__all__) - set(mpu.__all__)
    assert missing == {"RNGStatesTracker", "get_rng_state_tracker",
                       "mark_sharding", "current_mesh", "mesh_scope"}


# names the reference's subpackages export in `__all__` that the port has
# not ported yet, by subpackage
NOT_PORTED = {
    "distributed.fleet.utils": {
        "DistributedInfer", "HDFSClient", "LocalFS", "recompute_hybrid",
        "recompute_sequential"},
    "nn.functional": {
        "adaptive_avg_pool1d", "adaptive_avg_pool2d", "adaptive_avg_pool3d",
        "adaptive_log_softmax_with_loss", "adaptive_max_pool1d",
        "adaptive_max_pool2d", "adaptive_max_pool3d", "affine_grid",
        "alpha_dropout", "avg_pool1d", "avg_pool2d", "avg_pool3d",
        "batch_norm", "bilinear", "binary_cross_entropy",
        "binary_cross_entropy_with_logits", "celu", "channel_shuffle",
        "class_center_sample", "conv1d", "conv1d_transpose", "conv2d",
        "conv2d_transpose", "conv3d", "conv3d_transpose",
        "cosine_embedding_loss", "cosine_similarity", "cross_entropy",
        "ctc_loss", "dice_loss", "dropout", "dropout2d", "dropout3d", "elu",
        "elu_", "embedding", "embedding_bag", "feature_alpha_dropout",
        "flash_attention", "fold", "fractional_max_pool2d",
        "fractional_max_pool3d", "gather_tree", "gaussian_nll_loss", "gelu",
        "glu", "grid_sample", "group_norm", "gumbel_softmax", "hardshrink",
        "hardsigmoid", "hardswish", "hardtanh", "hardtanh_",
        "hinge_embedding_loss", "hsigmoid_loss", "instance_norm",
        "interpolate", "kl_div", "l1_loss", "label_smooth", "layer_norm",
        "leaky_relu", "leaky_relu_", "linear", "local_response_norm",
        "log_loss", "log_sigmoid", "log_softmax", "lp_pool1d", "lp_pool2d",
        "margin_cross_entropy", "margin_ranking_loss", "max_pool1d",
        "max_pool2d", "max_pool3d", "max_unpool1d", "max_unpool2d",
        "max_unpool3d", "maxout", "mish", "mse_loss",
        "multi_label_soft_margin_loss", "multi_margin_loss", "nll_loss",
        "normalize", "npair_loss", "one_hot", "pad", "pairwise_distance",
        "pixel_shuffle", "pixel_unshuffle", "poisson_nll_loss", "prelu",
        "relu", "relu6", "relu_", "rnnt_loss", "rrelu", "selu",
        "sequence_mask", "sigmoid", "sigmoid_focal_loss", "silu",
        "smooth_l1_loss", "soft_margin_loss", "softmax", "softmax_",
        "softmax_with_cross_entropy", "softplus", "softshrink", "softsign",
        "sparse_attention", "spectral_norm", "square_error_cost", "swish",
        "tanh", "tanh_", "tanhshrink", "temporal_shift", "thresholded_relu",
        "thresholded_relu_", "triplet_margin_loss",
        "triplet_margin_with_distance_loss", "unfold", "upsample",
        "zeropad2d"},
    "nn.quant": {
        "Stub", "llm_int8_linear", "quant_layers"},
    "profiler": {
        "PROFILER_LOG_DIR_ENV", "Profiler", "ProfilerState", "ProfilerTarget",
        "RecordEvent", "TracerEventType", "TrainingMonitor", "active_monitor",
        "benchmark", "compile_log", "cost", "counters", "default_log_dir",
        "export_chrome_tracing", "exposition", "grad_global_norm",
        "host_events", "load_profiler_result", "make_scheduler",
        "register_counter_provider", "unregister_counter_provider"},
    "serving": {
        "CompileCache", "ProgramCache"},
    "utils": {
        "check_numerics", "deprecated", "dlpack", "download",
        "enable_check_nan_inf", "flags", "get_flags", "require_version",
        "run_check", "set_flags", "try_import", "unique_name"},
}


def test_exports_walk_the_references_less_the_unported():
    """Every ported subpackage whose reference counterpart declares
    `__all__` exports the reference's names, less NOT_PORTED; each name
    listed there is still absent from the port and present in the
    reference (the list shrinks as slices land). The names the
    reference's `models` package imports at its top (it has no
    `__all__`) are exported too."""
    import importlib
    import pkgutil

    import paddle_tpu_torch
    walked = set()
    for m in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                   "paddle_tpu_torch."):
        port = importlib.import_module(m.name)
        if not hasattr(port, "__path__"):
            continue
        ref = importlib.import_module(
            m.name.replace("paddle_tpu_torch", "paddle_tpu", 1))
        if not hasattr(ref, "__all__"):
            continue
        sub = m.name[len("paddle_tpu_torch."):]
        walked.add(sub)
        missing = set(ref.__all__) - set(getattr(port, "__all__", ()))
        unported = NOT_PORTED.get(sub, set())
        assert missing == unported, (sub, sorted(missing ^ unported))
    assert walked >= set(NOT_PORTED) | {"serving.fleet", "serving.lora",
                                        "serving.spec"}
    import paddle_tpu.models as ref_models
    import paddle_tpu_torch.models as models
    assert hasattr(ref_models, "jit_generate")
    assert "jit_generate" in models.__all__
