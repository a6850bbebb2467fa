"""The port stands alone: no file of ``repro_torch``, nor ``chip_smoke.py``
and the chip scripts beside it, nor the port's examples, imports JAX or the
reference package, the port
calls no library attention, norm, cross-entropy, optimizer or grouped GEMM,
the kernel wrappers have no fallback, entry points refuse to run on the CPU
unless asked, and CPU runs launch no kernel."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.config import TrainConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.cross_entropy import cross_entropy_bwd, cross_entropy_fwd  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode  # noqa: E402
from repro_torch.kernels.grouped_matmul import gmm, gmm_dw  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    paged_decode,
    paged_kv_write,
    paged_prefill,
)
from repro_torch.kernels.rmsnorm import layernorm, layernorm_bwd, rmsnorm  # noqa: E402
from repro_torch.kernels.sampling import fused_sample  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_bwd  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.serving.api import LLM  # noqa: E402
from repro_torch.training.loop import Trainer  # noqa: E402

KERNELS = (flash_attention_fwd, flash_attention_bwd, cross_entropy_fwd, cross_entropy_bwd, layernorm,
           layernorm_bwd, rmsnorm, flash_decode, fused_sample, paged_decode, paged_prefill,
           paged_kv_write, gmm, gmm_dw, ssd_scan, ssd_scan_bwd)

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


@pytest.mark.parametrize("path",
                         PORT_FILES + [ROOT / name for name in (
                             "chip_smoke.py", "ssd_route_faults.py", "attention_variants.py",
                             "gmm_variants.py", "moe_route_faults.py", "decode_variants.py",
                             "prefill_variants.py", "layernorm_variants.py",
                             "examples/finetune_lora_torch.py",
                             "examples/embed_cells_torch.py")],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_calls_no_library_attention_norm_or_compile():
    banned = {"scaled_dot_product_attention", "layer_norm", "rms_norm", "cudnn"}
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in banned, f"{path}: uses .{node.attr}"
                is_torch = isinstance(node.value, ast.Name) and node.value.id == "torch"
                assert not (is_torch and node.attr == "compile"), f"{path}: uses torch.compile"


def _dotted(node):
    """``a.b.c`` of an attribute chain, or None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    return ".".join([node.id] + parts[::-1]) if isinstance(node, ast.Name) else None


def test_port_calls_no_library_cross_entropy_or_optimizer():
    """``F.cross_entropy``, ``functional.nll_loss`` and ``torch.optim``
    are banned; the port's own ``ops.cross_entropy`` is not."""
    losses = {"cross_entropy", "nll_loss", "binary_cross_entropy", "log_softmax"}
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Attribute):
                name = _dotted(node) or ""
                owner = name.rsplit(".", 1)[0]
                assert not (node.attr in losses and (owner == "F" or owner.endswith("functional"))), \
                    f"{path}: uses {name}"
                assert not name.startswith("torch.optim"), f"{path}: uses {name}"
        for mod in _imported_modules(path):
            assert not mod.startswith("torch.optim"), f"{path}: imports {mod}"


def test_the_ban_catches_library_calls_but_not_the_ports_op():
    def hits(src):
        return [_dotted(n) for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Attribute)]

    assert "F.cross_entropy" in hits("F.cross_entropy(x, y)")
    assert "torch.nn.functional.nll_loss" in hits("torch.nn.functional.nll_loss(x, y)")
    assert "torch.optim.AdamW" in hits("torch.optim.AdamW(p)")
    assert hits("ops.cross_entropy(h, w, t)") == ["ops.cross_entropy"]


def test_kernel_wrappers_have_no_fallback():
    for name in ("flash_attention.py", "cross_entropy.py", "rmsnorm.py", "flash_decode.py",
                 "sampling.py", "paged_attention.py", "grouped_matmul.py", "ssd_scan.py", "ops.py"):
        tree = ast.parse((PORT / "kernels" / name).read_text())
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), name


def test_grouped_matmul_kernel_route_calls_no_library_product():
    """The wrapper hands the product to the hand-written kernel: no matmul
    (``@``, ``matmul``, ``mm``, ``bmm``, ``einsum``) and no library grouped
    GEMM in it, and ``torch._grouped_mm`` nowhere in the port; the plain
    version, which it calls only for CPU tensors, lives in ``ref.py``."""
    banned = {"_grouped_mm", "bmm", "baddbmm", "matmul", "mm", "einsum"}
    tree = ast.parse((PORT / "kernels" / "grouped_matmul.py").read_text())
    for node in ast.walk(tree):
        assert not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult))
        assert not (isinstance(node, ast.Attribute) and node.attr in banned), node.attr
    for path in PORT_FILES:
        assert "_grouped_mm" not in path.read_text(), path
    ops_tree = ast.parse((PORT / "kernels" / "ops.py").read_text())
    fn = next(n for n in ops_tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "grouped_matmul")
    assert {_dotted(n.func) for n in ast.walk(fn) if isinstance(n, ast.Call)} == \
        {"_plain", "_ref.grouped_matmul_ref", "_gm.grouped_matmul", "_i32"}


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


def test_trainer_needs_a_gpu_unless_the_model_is_on_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("esm2-650m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model_mod.build_model(cfg), TrainConfig())
    tr = Trainer(model_mod.build_model(cfg, device="cpu"), TrainConfig(), verbose=False)
    assert tr.model.device.type == "cpu"


def test_launcher_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "esm2-650m", "--smoke", "--steps", "1", "--seq", "32", "--batch", "2",
            "--mesh", "none", "--data-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(args)
    launch_train.main(args + ["--device", "cpu"])
    assert all(k.launches == 0 for k in KERNELS)


def test_cpu_runs_launch_no_kernel():
    model = model_mod.build_model(get_smoke_config("esm2-650m"), device="cpu")
    LLM(model, slots=2, max_len=32).embed([[1, 5, 6, 2], list(range(5, 25))])
    toks = torch.tensor([[1, 5, 6, 7, 8, 2, 0, 0]] * 2, dtype=torch.int32)
    batch = {"tokens": toks, "targets": toks, "loss_mask": (toks > 4).float()}
    loss, _ = model.loss_fn(model.params.tree(), batch)
    loss.backward()
    qwen = model_mod.build_model(get_smoke_config("qwen2-7b"), device="cpu")
    LLM(qwen, slots=2, max_len=48).generate([[1, 5, 6], [7, 8, 9, 10]])
    LLM(qwen, slots=2, max_len=48, cache_layout="paged", page_size=8, prefix_cache=True,
        prefill_chunk=4).generate([[1, 5, 6, 7, 8, 9, 10, 11, 12], [1, 5, 6, 7, 8, 9, 10, 11]])
    scout = model_mod.build_model(get_smoke_config("llama4-scout-17b-a16e"), device="cpu")
    LLM(scout, slots=2, max_len=48).generate([[1, 5, 6], [7, 8, 9, 10]])
    loss, _ = scout.loss_fn(scout.params.tree(), {"tokens": toks})
    loss.backward()
    jamba = model_mod.build_model(get_smoke_config("jamba-1.5-large-398b"), device="cpu")
    LLM(jamba, slots=2, max_len=48).generate([[1, 5, 6], [7, 8, 9, 10]])
    loss, _ = jamba.loss_fn(jamba.params.tree(), {"tokens": toks})
    loss.backward()
    assert all(k.launches == 0 for k in KERNELS), [k.launches for k in KERNELS]


def test_encoder_decoder_and_frontend_cpu_runs_launch_no_kernel(monkeypatch):
    """Reduced MolMIM trains and generates through ``launch.serve.generate``,
    Whisper and InternVL2 serve through ``LLM.generate``, all on the CPU
    without a kernel launch; ``generate`` runs where the model is, and the
    model needs a GPU unless asked for the CPU."""
    from repro_torch.launch.serve import generate
    from repro_torch.serving.sampling import SamplingParams

    molmim = model_mod.build_model(get_smoke_config("molmim-65m"), device="cpu")
    toks = torch.tensor([[1, 5, 6, 7, 8, 2, 0, 0]] * 2, dtype=torch.int32)
    loss, _ = molmim.loss_fn(molmim.params.tree(), {"tokens": toks, "src_tokens": toks})
    loss.backward()
    out, _ = generate(molmim, None, {"tokens": toks[:, :3].numpy(), "src_tokens": toks.numpy()},
                      max_len=16, steps=4)
    assert out.device.type == "cpu" and out.shape == (2, 4)
    whisper = model_mod.build_model(get_smoke_config("whisper-medium"), device="cpu")
    LLM(whisper, slots=2, max_len=24, extra_batch={"enc_embeds": torch.zeros(1, 16, 256)}) \
        .generate([[1, 5, 6], [7, 8, 9, 10]], SamplingParams(max_new=4))
    vlm = model_mod.build_model(get_smoke_config("internvl2-26b"), device="cpu")
    LLM(vlm, slots=2, max_len=32, cache_layout="paged", page_size=8,
        extra_batch={"img_embeds": torch.zeros(1, 16, 256)}).generate([[1, 5, 6], [7, 8]],
                                                                     SamplingParams(max_new=4))
    assert all(k.launches == 0 for k in KERNELS), [k.launches for k in KERNELS]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        model_mod.build_model(get_smoke_config("molmim-65m"))


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc()


def test_build_key_covers_the_shared_header(monkeypatch, tmp_path):
    sources = sorted(p.name for p in _build.CSRC.glob("*.cu"))
    for name in sources + ["mma.cuh"]:
        (tmp_path / name).write_bytes((_build.CSRC / name).read_bytes())
    for name in sources:       # one copy of the tensor-core wrappers, in the header
        text = (tmp_path / name).read_text()
        assert '#include "mma.cuh"' in text and "struct Mma" not in text, name
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    stems = [n[:-3] for n in sources]
    before = {n: _build.lib_path(n) for n in stems}
    (tmp_path / "mma.cuh").write_text((tmp_path / "mma.cuh").read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n) for n in stems}
    assert all(before[n] != after[n] for n in stems)     # a header edit rebuilds every source
    (tmp_path / sources[0]).write_text((tmp_path / sources[0]).read_text() + "\n// edited\n")
    again = {n: _build.lib_path(n) for n in stems}
    assert [n for n in stems if again[n] != after[n]] == [stems[0]]


def test_the_mesh_modules_are_held_to_these_rules():
    """The mesh path's modules are among the files the import rules walk."""
    names = {p.relative_to(PORT).as_posix() for p in PORT_FILES}
    assert {"parallel/__init__.py", "parallel/sharding.py", "launch/mesh.py",
            "launch/shapes.py"} <= names


def test_launcher_on_a_mesh_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    """``--mesh 1x1`` resolves the device before it starts a process group:
    no GPU and no ``--device`` raises; ``--device cpu`` trains a Gloo world
    of one, launches no kernel and leaves no process group behind."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--arch", "esm2-650m", "--smoke", "--steps", "1", "--seq", "32", "--batch", "2",
            "--mesh", "1x1", "--data-dir", str(tmp_path)]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(args)
    assert not torch.distributed.is_initialized()
    launch_train.main(args + ["--device", "cpu"])
    assert not torch.distributed.is_initialized()
    assert all(k.launches == 0 for k in KERNELS)
