"""The port's training launcher (``repro_torch.launch.train``) and its
trace: ``main`` end to end on the CPU with the data plane, a resume and
the history file, and on reduced Mamba2's size-aware causal batches;
``make_batches`` against the reference launcher's; the
meshes it refuses; ``trace_ctx``; and the GPU it needs unless asked for
the CPU."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import repro.configs as jax_configs  # noqa: E402
from repro.core.config import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.config import TrainConfig  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs.profile import trace_ctx  # noqa: E402

ARGS = ["--arch", "esm2-650m", "--smoke", "--device", "cpu", "--batch", "4", "--seq", "64",
        "--sharded-data", "--max-tokens-per-batch", "512", "--producer", "2", "--mesh", "none"]


def test_main_runs_resumes_and_writes_history(tmp_path, capsys):
    common = ARGS + ["--data-dir", str(tmp_path / "data"), "--ckpt-dir", str(tmp_path / "ck"),
                     "--ckpt-every", "2"]
    train.main(common + ["--steps", "2"])
    assert os.listdir(tmp_path / "ck") == ["step_2"]
    out = tmp_path / "hist.json"
    train.main(common + ["--steps", "4", "--resume", "auto", "--history-out", str(out),
                         "--metrics-dir", str(tmp_path / "m"), "--profile", str(tmp_path / "prof")])
    text = capsys.readouterr().out
    assert f"resume: {tmp_path / 'ck' / 'step_2'}" in text
    assert "step timer:" in text and "train_step: n=2" in text and "final loss" in text
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [3] and np.isfinite(hist[-1]["loss"])
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_2", "step_4"]
    assert sorted(os.listdir(tmp_path / "m")) == ["train.prom", "train_metrics.json"]
    assert any(f.endswith(".pt.trace.json") for f in os.listdir(tmp_path / "prof"))


def test_main_trains_mamba2_on_size_aware_batches(tmp_path, monkeypatch):
    """``--arch mamba2-2.7b`` (reduced, on the CPU): causal batches from the
    sharded store under a token budget, so the SSD scan and its backward
    see a new (B, S) at each step; the history file holds the last step's
    finite loss."""
    shapes = []

    class Recording(train.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            step_fn = self._step_fn
            self._step_fn = lambda st, b: (shapes.append(tuple(b["tokens"].shape)),
                                           step_fn(st, b))[1]

    monkeypatch.setattr(train, "Trainer", Recording)
    out = tmp_path / "hist.json"
    train.main(["--arch", "mamba2-2.7b", "--smoke", "--device", "cpu", "--steps", "3",
                "--batch", "2", "--seq", "128", "--sharded-data", "--max-tokens-per-batch",
                "512", "--mesh", "none", "--data-dir", str(tmp_path / "data"), "--history-out",
                str(out)])
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [0, 2] and all(np.isfinite(h["loss"]) for h in hist)
    assert len(shapes) == 3 and len(set(shapes)) > 1
    assert all(b * s <= 512 for b, s in shapes)


@pytest.mark.parametrize("kind", ["mlm_size_aware", "mlm_cluster", "clm_size_aware", "clm_packed"])
def test_make_batches_equals_the_reference_launchers(tmp_path, kind):
    arch = "esm2-650m" if kind.startswith("mlm") else "qwen2-7b"
    max_tokens = 1024 if kind.endswith("size_aware") else 0
    cfg, jcfg = get_smoke_config(arch), jax_configs.get_smoke_config(arch)
    tc, jtc = TrainConfig(global_batch=4, seq_len=128), JaxTrainConfig(global_batch=4, seq_len=128)
    a = train.make_batches(cfg, tc, str(tmp_path / "p"), seed=3, sharded=True,
                           max_tokens=max_tokens, producer_depth=2)
    b = jax_train.make_batches(jcfg, jtc, str(tmp_path / "r"), seed=3, sharded=True,
                               max_tokens=max_tokens, producer_depth=2)
    with a, b:
        for _ in range(6):
            x, y = next(a), next(b)
            assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)
        assert json.dumps(a.state_dict()) == json.dumps(b.state_dict())     # the same cursor


def test_encoder_decoder_batches_name_their_slice(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(get_smoke_config("qwen2-7b"), is_encoder_decoder=True)
    with pytest.raises(NotImplementedError, match="slice 7"):
        train.make_batches(cfg, TrainConfig(global_batch=2, seq_len=32), str(tmp_path))


@pytest.mark.parametrize("mesh", ["2x1", "4x2", "auto-on-two-cards"])
def test_meshes_other_than_one_card_raise(mesh, monkeypatch, tmp_path):
    if mesh == "auto-on-two-cards":
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        mesh = "auto"
    with pytest.raises(NotImplementedError, match="slice 8"):
        train.main(ARGS[:-2] + ["--mesh", mesh, "--steps", "1", "--data-dir", str(tmp_path)])
    train.check_mesh("none")


def test_trace_ctx_writes_a_trace_and_is_a_noop_without_a_dir(tmp_path):
    with trace_ctx(str(tmp_path / "t")):
        torch.ones(4, 4) @ torch.ones(4, 4)
    files = os.listdir(tmp_path / "t")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert "traceEvents" in json.loads((tmp_path / "t" / files[0]).read_text())
    for falsy in ("", None):
        with trace_ctx(falsy):
            pass
    with trace_ctx(str(tmp_path / "outer")):       # a second profiler nests as a no-op
        with trace_ctx(str(tmp_path / "inner")):
            torch.ones(2) + 1
    assert not (tmp_path / "inner").exists() and os.listdir(tmp_path / "outer")

