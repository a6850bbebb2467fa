"""The port stands alone: no file of ``repro_torch`` nor ``chip_smoke.py``
imports JAX or the reference package, the port calls no library attention
or norm, the kernel wrappers have no fallback, entry points refuse to run
on the CPU unless asked, and CPU runs launch no kernel."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.rmsnorm import layernorm  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py"))


def _imported_modules(path):
    mods = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.append(node.module)
    return mods


@pytest.mark.parametrize("path", PORT_FILES + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_calls_no_library_attention_norm_or_compile():
    banned = {"scaled_dot_product_attention", "layer_norm", "cudnn"}
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in banned, f"{path}: uses .{node.attr}"
                is_torch = isinstance(node.value, ast.Name) and node.value.id == "torch"
                assert not (is_torch and node.attr == "compile"), f"{path}: uses torch.compile"


def test_kernel_wrappers_have_no_fallback():
    for name in ("flash_attention.py", "rmsnorm.py", "ops.py"):
        tree = ast.parse((PORT / "kernels" / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


def test_import_leaves_jax_out_of_sys_modules():
    mods = ", ".join(
        "repro_torch." + ".".join(p.relative_to(PORT).with_suffix("").parts)
        for p in PORT_FILES if p.name != "__init__.py"
    )
    code = (f"import sys, importlib\nfor m in '{mods}'.split(', '): importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr


def test_build_model_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("esm2-650m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_mod.build_model(cfg)
    assert model_mod.build_model(cfg, device="cpu").device.type == "cpu"


def test_cpu_runs_launch_no_kernel():
    model = model_mod.build_model(get_smoke_config("esm2-650m"), device="cpu")
    LLM(model, slots=2, max_len=32).embed([[1, 5, 6, 2], list(range(5, 25))])
    assert flash_attention_fwd.launches == 0 and layernorm.launches == 0


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()
