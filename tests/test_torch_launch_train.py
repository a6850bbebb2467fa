"""The port's training launcher (``repro_torch.launch.train``) and its
trace: ``main`` end to end on the CPU with the data plane, a resume and
the history file, on reduced Mamba2's size-aware causal batches and on
reduced MolMIM's seq2seq batches;
``make_batches`` against the reference launcher's (Geneformer's
``--smoke`` MLM batches among them); the meshes it refuses and a ``1x1``
mesh on a Gloo world of one; ``trace_ctx``; and the GPU it needs unless
asked for the CPU."""
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


@pytest.mark.parametrize("kind", ["mlm_size_aware", "mlm_cluster", "clm_size_aware", "clm_packed",
                                  "geneformer_cluster"])
def test_make_batches_equals_the_reference_launchers(tmp_path, kind):
    arch = {"mlm": "esm2-650m", "clm": "qwen2-7b", "geneformer": "geneformer-106m"}[
        kind.split("_")[0]]
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
    """MolMIM's batches (``Seq2SeqBatches``): the reference launcher's CLM
    packing with ``src_tokens`` mirroring ``tokens``, batch for batch, and
    the same cursor, which a restored pipeline resumes from."""
    cfg, jcfg = get_smoke_config("molmim-65m"), jax_configs.get_smoke_config("molmim-65m")
    tc, jtc = TrainConfig(global_batch=4, seq_len=64), JaxTrainConfig(global_batch=4, seq_len=64)
    a = train.make_batches(cfg, tc, str(tmp_path / "p"), seed=5, max_tokens=512)
    b = jax_train.make_batches(jcfg, jtc, str(tmp_path / "r"), seed=5, max_tokens=512)
    assert isinstance(a, train.Seq2SeqBatches)
    ia, ib = iter(a), iter(b)
    for _ in range(3):
        x, y = next(ia), next(ib)
        assert sorted(x) == sorted(y) == ["src_tokens", "tokens"]
        assert x["tokens"].shape == (4, 64) and np.array_equal(x["src_tokens"], x["tokens"])
        assert all(np.array_equal(x[k], y[k]) for k in x)
    assert json.dumps(a.state_dict()) == json.dumps(b.state_dict())     # the same cursor
    c = train.make_batches(cfg, tc, str(tmp_path / "p"), seed=5)
    c.load_state_dict(a.state_dict())
    assert all(np.array_equal(u, v) for u, v in zip(next(iter(c)).values(), next(ia).values()))


def test_main_trains_molmim_on_seq2seq_batches(tmp_path):
    """``--arch molmim-65m`` (reduced, on the CPU): ``Seq2SeqBatches``
    through ``Trainer.run``; the history holds finite losses."""
    out = tmp_path / "hist.json"
    train.main(["--arch", "molmim-65m", "--smoke", "--device", "cpu", "--steps", "3",
                "--batch", "4", "--seq", "32", "--mesh", "none", "--data-dir",
                str(tmp_path / "data"), "--history-out", str(out)])
    hist = json.loads(out.read_text())
    assert [h["step"] for h in hist] == [0, 2] and all(np.isfinite(h["loss"]) for h in hist)


@pytest.mark.parametrize("mesh", ["2x1", "4x2", "auto-on-two-cards"])
def test_meshes_other_than_one_card_raise(mesh, monkeypatch, tmp_path):
    """A mesh the world cannot hold raises: 2x1 and 4x2 on a world of one
    process, and on a world of two ranks (torchrun's ``WORLD_SIZE``) a
    ``none`` that would train one replica a rank; ``auto`` on a world of
    one trains without a mesh."""
    if mesh == "auto-on-two-cards":
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(ValueError, match="one replica"):
            train.main(ARGS[:-2] + ["--mesh", "none", "--steps", "1", "--data-dir",
                                    str(tmp_path)])
        monkeypatch.delenv("WORLD_SIZE")
        assert train.build_mesh("auto", torch.device("cpu")) is None
        return
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        train.main(ARGS[:-2] + ["--mesh", mesh, "--steps", "1", "--data-dir", str(tmp_path)])


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



def test_main_trains_on_a_1x1_mesh_as_without_one(tmp_path):
    """``--mesh 1x1`` (a Gloo world of one, no torchrun): the sharded step
    over groups of one rank gives the mesh-free run's history."""
    hist = {}
    for mesh in ("none", "1x1"):
        out = tmp_path / f"hist_{mesh}.json"
        train.main(["--arch", "esm2-650m", "--smoke", "--device", "cpu", "--batch", "4", "--seq",
                    "32", "--steps", "3", "--mesh", mesh, "--data-dir", str(tmp_path / "data"),
                    "--history-out", str(out)])
        hist[mesh] = json.loads(out.read_text())
    assert not torch.distributed.is_initialized()
    assert [(h["loss"], h["grad_norm"]) for h in hist["1x1"]] == \
        [(h["loss"], h["grad_norm"]) for h in hist["none"]]
