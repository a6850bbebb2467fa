"""The port's mesh path in one Gloo world of 4 CPU processes, against the
reference's single-device results (its own mesh paths do not run on this
JAX; its tests define the mesh path's correctness the same way, as the
mesh-free run).

The module fixture computes the reference's numbers here (the only place
JAX is imported), writes them and the bridged weights to a directory, and
starts four children that run this file as a script: each imports torch
and the port only, joins the world over a file store, runs every case
below in the same order and rank 0 writes what it found.  A child that
fails, or a world that outlives its deadline, is killed and fails the
tests.

* (a) a dense decoder (8 heads, 2 kv heads, fp32) on the reference's
  weights: head-TP and context parallelism on (2, 2), head-TP with the kv
  heads replicated on (1, 4), and a (2, 1, 2) ``pod x data x model`` mesh
  (d): one train step's loss within 1e-4 and grad norm within 1e-3
  relative of the reference's ``make_train_step``, and every gathered
  gradient leaf within 1e-5 relative of the port's mesh-free gradients;
  the remat policies' gradients equal under head-TP; K/V heads that
  straddle the model ranks (12 over 3 on two ranks) against the mesh-free
  model;
* (b) reduced ESM-2 MLM with uneven masks across the data ranks: the loss
  is the global token mean (not the mean of the ranks' means), the
  gradients the mesh-free ones, gradient accumulation token-weighted, and
  a non-finite step skipped on every rank;
* (c) ``validate``'s switch to context parallelism with 6 heads on (1, 4);
* (e) a 4-step ``Trainer`` run on (2, 2) against the reference's Trainer
  history; its checkpoint restored on (4, 1) and on one device with
  identical leaves, and 2 more steps from it on both;
* (f) reduced MoE (Scout) and SSM (Mamba2) models on (4, 1) equal to the
  mesh-free model, and the families the ``model`` axis does not split
  refused on (2, 2).
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
DEADLINE_S = 420
DENSE = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
             d_ff=128, vocab_size=128, dtype="float32")
SWITCH = dict(DENSE, num_heads=6, d_model=48)          # 6 heads do not divide over 4
TRAIN = dict(global_batch=8, seq_len=32, total_steps=4, log_every=1, warmup_steps=1,
             decay_steps=1, learning_rate=1e-3)
A_CASES = [  # (name, mesh shape, axes, attention_parallelism, config)
    ("head_tp_2x2", (2, 2), ("data", "model"), "head_tp", "dense"),
    ("context_2x2", (2, 2), ("data", "model"), "context", "dense"),
    ("kv_replicated_1x4", (1, 4), ("data", "model"), "head_tp", "dense"),
    ("pod_2x1x2", (2, 1, 2), ("pod", "data", "model"), "head_tp", "dense"),
    ("switch_1x4", (1, 4), ("data", "model"), "head_tp", "switch"),
]


# --------------------------------------------------------------------- #
# the reference's side (this process)
# --------------------------------------------------------------------- #
def _reference(out: Path):
    import jax

    from repro.core.config import ModelConfig, TrainConfig
    from repro.data.dataset import build_synthetic_protein_memmap
    from repro.data.pipeline import CLMBatches
    from repro.models.model import build_model
    from repro.training import train_step as TS
    from repro.training.loop import Trainer

    tokens = np.random.default_rng(1).integers(0, 128, size=(8, 32)).astype(np.int32)
    inp = {"tokens": tokens, "params": {}, "step": {}}
    for name, kw in (("dense", DENSE), ("switch", SWITCH)):
        model = build_model(ModelConfig(**kw))
        tc = TrainConfig(total_steps=1)
        state = TS.init_train_state(model, jax.random.PRNGKey(0), tc)
        inp["params"][name] = jax.device_get(state.params)
        _, m = jax.jit(TS.make_train_step(model, tc))(state, {"tokens": tokens})
        inp["step"][name] = (float(m["loss"]), float(m["grad_norm"]))
    ds, _ = build_synthetic_protein_memmap(str(out / "ref_prot"), n=200, seed=0)
    it = iter(CLMBatches(ds, 8, 32, seed=0))
    inp["clm_tokens"] = [next(it)["tokens"] for _ in range(6)]
    _, hist = Trainer(build_model(ModelConfig(**DENSE)), TrainConfig(**TRAIN),
                      verbose=False).run(CLMBatches(ds, 8, 32, seed=0))
    inp["history"] = [(h["step"], h["loss"], h["grad_norm"]) for h in hist]
    return inp


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    out = tmp_path_factory.mktemp("gloo4")
    inp = _reference(out)
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    t0 = time.monotonic()
    try:
        while any(p.poll() is None for p in procs):
            failed = any(p.returncode not in (None, 0) for p in procs)
            if failed or time.monotonic() - t0 > DEADLINE_S:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * WORLD:
        tails = "\n".join(f"--- rank {r} (rc {rc}) ---\n"
                          + (out / f"rank{r}.log").read_text()[-3000:] for r, rc in enumerate(rcs))
        pytest.fail(f"the Gloo world failed after {time.monotonic() - t0:.0f} s:\n{tails}")
    with open(out / "results.pkl", "rb") as f:
        res = pickle.load(f)
    res["seconds"] = time.monotonic() - t0
    return inp, res


# --------------------------------------------------------------------- #
# the tests
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", [c[0] for c in A_CASES])
def test_sharded_step_matches_the_reference_single_device_step(world, case):
    inp, res = world
    r = res["a"][case]
    ref_loss, ref_gnorm = inp["step"][r["config"]]
    assert abs(r["loss"] - ref_loss) < 1e-4, (r["loss"], ref_loss)
    assert abs(r["grad_norm"] - ref_gnorm) / max(ref_gnorm, 1.0) < 1e-3, (r["grad_norm"], ref_gnorm)
    # the loss_fn's loss and each gathered gradient leaf against the port's
    # mesh-free model on the same weights
    assert abs(r["grad_loss"] - r["free_loss"]) < 1e-5
    assert max(r["grad_rel_err"]) < 1e-5, r["grad_rel_err"]
    assert r["attention_parallelism"] == ("context" if case.startswith(("context", "switch"))
                                          else "head_tp")


def test_kv_heads_straddling_the_model_ranks_match_the_mesh_free_model(world):
    """12 query heads over 3 K/V heads on two model ranks: rank 0's six
    query heads use K/V heads 0 and 1, rank 1's heads 1 and 2, so each
    takes one K/V head per query head."""
    _, res = world
    r = res["kv_straddle"]
    assert r["attention_parallelism"] == "head_tp"
    assert abs(r["loss"] - r["free_loss"]) < 1e-6, (r["loss"], r["free_loss"])
    assert max(r["grad_rel_err"]) < 1e-5, r["grad_rel_err"]


def test_remat_policies_give_the_same_gradients_under_head_tp(world):
    _, res = world
    assert res["remat_same"], "none, block and dots differ on (2, 2) head-TP"


@pytest.mark.parametrize("case", ["data_4x1", "head_tp_2x2", "context_2x2"])
def test_uneven_mlm_masks_give_the_global_token_mean(world, case):
    _, res = world
    r = res["b"][case]
    assert len(set(r["rank_tokens"])) > 1, r["rank_tokens"]      # uneven by construction
    assert abs(r["loss"] - r["free_loss"]) < 1e-6 * max(1.0, abs(r["free_loss"]))
    assert abs(r["mean_of_rank_means"] - r["free_loss"]) > 1e-3    # the test has teeth
    assert max(r["grad_rel_err"]) < 1e-5, r["grad_rel_err"]


def test_accumulation_and_the_nonfinite_guard_keep_their_semantics(world):
    _, res = world
    acc = res["b"]["accum"]
    assert abs(acc["loss"] - acc["free_loss"]) < 1e-6
    assert abs(acc["grad_norm"] - acc["free_grad_norm"]) < 1e-5 * acc["free_grad_norm"]
    assert acc["param_max_err"] < 1e-6, acc["param_max_err"]
    g = res["b"]["guard"]
    assert g["skipped"] == [1.0] * WORLD and g["unchanged"] and g["step"] == 0


def test_trainer_trajectory_matches_the_reference_trainer(world):
    inp, res = world
    e = res["e"]
    assert e["batches_equal"], "the port's CLM batches are not the reference's"
    assert [h[0] for h in e["history"]] == [h[0] for h in inp["history"]] == [0, 1, 2, 3]
    for (_, loss, gn), (_, rloss, rgn) in zip(e["history"], inp["history"]):
        assert abs(loss - rloss) < 1e-4, (loss, rloss)
        assert abs(gn - rgn) / max(rgn, 1.0) < 1e-3, (gn, rgn)


@pytest.mark.parametrize("target", ["data_4x1", "one_device"])
def test_checkpoint_restores_on_another_mesh_and_trains_on(world, target):
    _, res = world
    r = res["e"]["restore"][target]
    assert r["identical"] and r["opt_step"] == 4 and r["step_idx"] == 4
    assert r["continued_steps"] == [4, 5]
    other = res["e"]["restore"]["one_device" if target == "data_4x1" else "data_4x1"]
    for a, b in zip(r["continued_loss"], other["continued_loss"]):
        assert abs(a - b) < 1e-4


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_moe_and_ssm_train_on_data_ranks_as_the_mesh_free_model(world, family):
    _, res = world
    r = res["f"][family]
    assert abs(r["loss"] - r["free_loss"]) < 1e-5, (r["loss"], r["free_loss"])
    assert max(r["grad_rel_err"]) < 1e-5, r["grad_rel_err"]
    assert abs(r["step_grad_norm"] - r["free_step_grad_norm"]) < 1e-5 * r["free_step_grad_norm"]
    for k, (got, want) in r["metrics"].items():
        assert np.allclose(got, want, rtol=1e-5, atol=1e-6), (k, got, want)


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "mamba2-2.7b", "molmim-65m"])
def test_the_model_axis_refuses_moe_ssm_and_encoder_decoders(world, name):
    _, res = world
    assert "14b" in res["f"]["refused"][name]


def test_the_world_stays_cheap(world):
    """One world runs every case: its children's start, the cases and the
    exit take well under the deadline."""
    _, res = world
    assert res["seconds"] < DEADLINE_S / 2, res["seconds"]


# --------------------------------------------------------------------- #
# the children (torch and the port only)
# --------------------------------------------------------------------- #
def _rel_errs(got, want):
    return [float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(got, want)]


def _child(rank: int, out: Path) -> None:
    import dataclasses
    import datetime

    import torch.distributed as dist

    from repro_torch.checkpoint.bridge import from_jax_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config import ModelConfig, ParallelConfig, TrainConfig
    from repro_torch.core.module import tree_leaves
    from repro_torch.data.dataset import build_synthetic_protein_memmap
    from repro_torch.data.pipeline import CLMBatches
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model, build_model
    from repro_torch.training.loop import Trainer
    from repro_torch.training.train_step import init_train_state, make_train_step

    torch.set_num_threads(1)
    with open(out / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    meshes = {}

    def mesh(shape, axes=("data", "model")):
        if (shape, axes) not in meshes:
            meshes[shape, axes] = make_test_mesh(shape, axes)
        return meshes[shape, axes]

    def whole_grads(model, batch):
        """(loss, every gradient leaf made whole) of one loss_fn + backward."""
        params = model.params.tree()
        leaves = tree_leaves(params)
        loss, metrics = model.loss_fn(model.compute_params(params), batch)
        grads = torch.autograd.grad(loss, leaves)
        if model.sharded:
            grads = [model.ctx.gather_whole(g, ls.store)
                     for g, ls in zip(grads, tree_leaves(model.specs))]
        return float(loss), grads, metrics

    def step(model, tc, batch):
        _, m = make_train_step(model, tc)(init_train_state(model), batch)
        return m

    def local(model, batch):
        return {k: torch.as_tensor(model.ctx.batch_rows(v)) for k, v in batch.items()}

    res = {"a": {}, "b": {}, "e": {}, "f": {}}
    cfgs = {"dense": ModelConfig(**DENSE), "switch": ModelConfig(**SWITCH)}
    tokens = torch.from_numpy(inp["tokens"])
    tc1 = TrainConfig(total_steps=1)

    # (a), (c), (d): one step on the reference's weights
    free = {n: whole_grads(Model(c, from_jax_params(inp["params"][n])), {"tokens": tokens})
            for n, c in cfgs.items()}
    for name, shape, axes, mode, cname in A_CASES:
        cfg = cfgs[cname]
        m = Model(cfg, from_jax_params(inp["params"][cname]),
                  ParallelConfig(attention_parallelism=mode), mesh(shape, axes))
        b = local(m, {"tokens": inp["tokens"]})
        loss, grads, _ = whole_grads(m, b)
        metrics = step(m, tc1, b)
        res["a"][name] = dict(config=cname, loss=float(metrics["loss"]),
                              grad_norm=float(metrics["grad_norm"]), grad_loss=loss,
                              free_loss=free[cname][0],
                              grad_rel_err=_rel_errs(grads, free[cname][1]),
                              attention_parallelism=m.pc.attention_parallelism)
    straddle = ModelConfig(**dict(DENSE, num_heads=12, num_kv_heads=3, d_model=96))
    f_loss, f_grads, _ = whole_grads(build_model(straddle, device="cpu", seed=0),
                                     {"tokens": tokens})
    m = build_model(straddle, ParallelConfig(), mesh((2, 2)), device="cpu", seed=0)
    loss, grads, _ = whole_grads(m, local(m, {"tokens": inp["tokens"]}))
    res["kv_straddle"] = dict(loss=loss, free_loss=f_loss, grad_rel_err=_rel_errs(grads, f_grads),
                              attention_parallelism=m.pc.attention_parallelism)
    digests = []
    for policy in ("none", "block", "dots"):
        m = Model(cfgs["dense"], from_jax_params(inp["params"]["dense"]),
                  ParallelConfig(remat_policy=policy), mesh((2, 2)))
        digests.append(whole_grads(m, local(m, {"tokens": inp["tokens"]}))[1])
    res["remat_same"] = all(torch.equal(a, b) for d in digests[1:] for a, b in zip(d, digests[0]))

    # (b) MLM with uneven masks over the data ranks
    esm = get_smoke_config("esm2-650m")
    rng = np.random.default_rng(2)
    mlm = {"tokens": rng.integers(4, 33, size=(8, 32)).astype(np.int32),
           "targets": rng.integers(4, 33, size=(8, 32)).astype(np.int32)}
    mask = np.zeros((8, 32), np.float32)
    for i in range(8):                      # row i masks 3 (i + 1) positions
        mask[i, rng.permutation(32)[:3 * (i + 1)]] = 1.0
    mlm["loss_mask"] = mask
    full = {k: torch.from_numpy(v) for k, v in mlm.items()}
    free_esm = build_model(esm, device="cpu", seed=0)
    f_loss, f_grads, _ = whole_grads(free_esm, full)
    for name, shape, mode in (("data_4x1", (4, 1), "head_tp"), ("head_tp_2x2", (2, 2), "head_tp"),
                              ("context_2x2", (2, 2), "context")):
        m = build_model(esm, ParallelConfig(attention_parallelism=mode), mesh(shape),
                        device="cpu", seed=0)
        b = local(m, mlm)
        loss, grads, _ = whole_grads(m, b)
        own, _ = free_esm.loss_fn(free_esm.params.tree(), b)     # this rank's own mean
        means = [None] * WORLD
        dist.all_gather_object(means, (float(own), float(b["loss_mask"].sum())))
        res["b"][name] = dict(loss=loss, free_loss=f_loss, grad_rel_err=_rel_errs(grads, f_grads),
                              mean_of_rank_means=float(np.mean([x[0] for x in means])),
                              rank_tokens=[x[1] for x in means])
    tc2 = TrainConfig(total_steps=1, accum_steps=2, learning_rate=1e-2, warmup_steps=1,
                      weight_decay=0.1)
    m = build_model(esm, ParallelConfig(), mesh((2, 2)), device="cpu", seed=0)
    f = build_model(esm, device="cpu", seed=0)
    got, want = step(m, tc2, local(m, mlm)), step(f, tc2, full)
    params = [m.ctx.gather_whole(p.detach(), ls.store)
              for p, ls in zip(tree_leaves(m.params.tree()), tree_leaves(m.specs))]
    res["b"]["accum"] = dict(loss=float(got["loss"]), free_loss=float(want["loss"]),
                             grad_norm=float(got["grad_norm"]),
                             free_grad_norm=float(want["grad_norm"]),
                             param_max_err=max(float((a - b.detach()).abs().max()) for a, b in
                                               zip(params, tree_leaves(f.params.tree()))))
    m = build_model(esm, ParallelConfig(), mesh((2, 2)), device="cpu", seed=0)
    state = init_train_state(m)
    with torch.no_grad():
        tree_leaves(state.params)[0].view(-1)[0] = float("nan")
    before = [p.detach().clone() for p in tree_leaves(state.params)]
    state, metrics = make_train_step(m, tc1)(state, local(m, mlm))
    skipped = [None] * WORLD
    dist.all_gather_object(skipped, float(metrics["skipped"]))
    res["b"]["guard"] = dict(skipped=skipped, step=int(state.opt.step), unchanged=all(
        torch.equal(a, b) for a, b in zip(before, tree_leaves(state.params)) if a.isfinite().all()))

    # (e) the Trainer on (2, 2), its checkpoint on (4, 1) and on one device
    ds, _ = build_synthetic_protein_memmap(str(out / f"prot{rank}"), n=200, seed=0)
    it = iter(CLMBatches(ds, 8, 32, seed=0))
    res["e"]["batches_equal"] = all(np.array_equal(next(it)["tokens"], t)
                                    for t in inp["clm_tokens"])
    tc = TrainConfig(**TRAIN)
    m22 = Model(cfgs["dense"], from_jax_params(inp["params"]["dense"]), ParallelConfig(),
                mesh((2, 2)))
    tr = Trainer(m22, tc, verbose=False)
    state, hist = tr.run(CLMBatches(ds, 8, 32, seed=0))
    res["e"]["history"] = [(h["step"], h["loss"], h["grad_norm"]) for h in hist]
    ck = str(out / "ck")
    tr.save(ck)

    def whole_state(model, st):
        trees = (st.params, st.opt.mu, st.opt.nu)
        if not model.sharded:
            return [t.detach() for tree in trees for t in tree_leaves(tree)]
        return [model.ctx.gather_whole(t.detach(), ls.store) for tree in trees
                for t, ls in zip(tree_leaves(tree), tree_leaves(model.specs))]

    saved = whole_state(m22, state)
    res["e"]["restore"] = {}
    tc6 = dataclasses.replace(tc, total_steps=6)
    for target, mesh_ in (("data_4x1", mesh((4, 1))), ("one_device", None)):
        m = build_model(cfgs["dense"], ParallelConfig(), mesh_, device="cpu", seed=5)
        tr = Trainer(m, tc6, verbose=False)
        tr.prepare(CLMBatches(ds, 8, 32, seed=0), resume_from=ck)
        restored = whole_state(m, tr.state)
        r = dict(identical=all(torch.equal(a, b) for a, b in zip(restored, saved)),
                 opt_step=int(tr.state.opt.step), step_idx=tr.step_idx)
        while tr.step_idx < tc6.total_steps:
            tr.step()
        r.update(continued_steps=[h["step"] for h in tr.history],
                 continued_loss=[h["loss"] for h in tr.history])
        res["e"]["restore"][target] = r

    # (f) MoE and SSM over data ranks; the model axis refuses them
    batch = {"tokens": np.random.default_rng(3).integers(0, 512, size=(8, 32)).astype(np.int32)}
    keys = {"moe": ("aux_loss", "router_entropy", "router_drop_frac", "router_load"), "ssm": ()}
    for fam, name in (("moe", "llama4-scout-17b-a16e"), ("ssm", "mamba2-2.7b")):
        cfg = get_smoke_config(name)
        f = build_model(cfg, device="cpu", seed=0)
        m = build_model(cfg, ParallelConfig(), mesh((4, 1)), device="cpu", seed=0)
        f_loss, f_grads, f_m = whole_grads(f, {k: torch.from_numpy(v) for k, v in batch.items()})
        loss, grads, mm = whole_grads(m, local(m, batch))
        got = step(m, tc1, local(m, batch))
        want = step(f, tc1, {k: torch.from_numpy(v) for k, v in batch.items()})
        res["f"][fam] = dict(loss=loss, free_loss=f_loss, grad_rel_err=_rel_errs(grads, f_grads),
                             step_grad_norm=float(got["grad_norm"]),
                             free_step_grad_norm=float(want["grad_norm"]),
                             metrics={k: (mm[k].detach().numpy(), f_m[k].detach().numpy())
                                      for k in keys[fam]})
    res["f"]["refused"] = {}
    for name in ("llama4-scout-17b-a16e", "mamba2-2.7b", "molmim-65m"):
        try:
            build_model(get_smoke_config(name), ParallelConfig(), mesh((2, 2)), device="cpu")
            res["f"]["refused"][name] = ""
        except NotImplementedError as e:
            res["f"]["refused"][name] = str(e)

    if rank == 0:
        with open(out / "results.pkl", "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(int(sys.argv[1]), Path(sys.argv[2]))
