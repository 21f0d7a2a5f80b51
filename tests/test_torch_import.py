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
    """The in-process fleet and the exposition module are among those
    the probe imports."""
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
            "paddle_tpu_torch.profiler.exposition"} <= names
