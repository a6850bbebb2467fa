"""Tensor-parallel serving of the port in one Gloo world of 4 CPU processes,
against the reference's mesh-free engine (its own mesh tests define the
mesh engine's correctness the same way: token equality with the mesh-free
engine, ``tests/test_serving_sharded.py``).

The module fixture draws the reference's weights here (the only place JAX
is imported) for its small config (2 layers, d 64, 8/8 heads, fp32, vocab
64), the same with 8 query / 2 K/V heads, and reduced ESM-2 with 4 heads
and with 6, writes them to a directory and starts four children that run
this file as a script: each imports torch and the port only, joins the
world over a file store, runs every case below in the same order, and
rank 0 writes what the ranks found.  Meanwhile this process runs the
reference's engine over the dense, paged and prefix+chunk layouts (3
slots, max_len 64, 4 prompts alternating greedy and seeded sampling) and
reduced ESM-2's ``embed_pool``.  A child that fails, or a world that
outlives its deadline, is killed and fails the tests.

* parity: the engine on (1, 4) and (2, 2) in the three layouts gives the
  reference's tokens and the port's mesh-free engine's; with the K/V heads
  replicated (2 over 4 model ranks) on (1, 4) too;
* one host transfer per steady decode step on every rank of (2, 2), paged;
* each rank's pools hold its K/V heads, the block table and ``pos`` whole;
  after a run with prefix sharing, copy-on-write and preemption each
  rank's pools outside the null page equal its heads of the mesh-free
  engine's pools within 1e-5 (the residual after an all-reduce moves the
  last bits);
* ESM-2 embeddings under head-TP and under context parallelism (6 heads
  over 4), ``embed_pool`` and ``LLM.embed``;
* deadlines under clocks that run at a rate of their own on each rank:
  the same finish reasons everywhere, no hang;
* reduced Scout and Mamba2 on (4, 1) give the mesh-free tokens; MoE, SSM
  and encoder-decoder models on (2, 2), and generation under context
  parallelism, raise and name their ROADMAP items;
* ``launch.serve.main(["--mesh", "2x2", "--device", "cpu", ...])``: rank 0
  prints the summary, the others print nothing, every rank returns.
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
COMMON = dict(name="smoke", family="dense", num_layers=2, d_model=64, num_heads=8, num_kv_heads=8,
              d_ff=128, vocab_size=64, dtype="float32")
REPLICATED = dict(COMMON, num_kv_heads=2)            # 2 K/V heads over 4 model ranks
LAYOUTS = {
    "dense": dict(cache_layout="dense"),
    "paged": dict(cache_layout="paged", page_size=8),
    "prefix+chunk": dict(cache_layout="paged", page_size=8, prefix_cache=True, prefill_chunk=8),
}
PARITY_MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
REPLICATED_LAYOUTS = ("dense", "prefix+chunk")
EMBED_S = 16


def prompts(vocab: int):
    rng = np.random.default_rng(7)
    return [rng.integers(1, vocab, size=n).astype(np.int32) for n in (5, 11, 17, 9)]


def embed_batch():
    rng = np.random.default_rng(5)
    toks = rng.integers(4, 30, size=(3, EMBED_S)).astype(np.int32)
    return toks, np.array([16, 9, 3], np.int32)


# --------------------------------------------------------------------- #
# the reference's side (this process)
# --------------------------------------------------------------------- #
def _reference_inputs():
    """The weights every side serves: the reference's small config, its
    replicated-K/V variant and reduced ESM-2 with 4 and 6 heads."""
    import dataclasses

    import jax

    from repro.configs import get_config
    from repro.core.config import ModelConfig, reduced
    from repro.models.model import build_model

    inp = {"params": {}, "cfg": {}}
    for name, kw in (("common", COMMON), ("replicated", REPLICATED)):
        inp["cfg"][name] = ModelConfig(**kw)
    esm = reduced(get_config("esm2-650m"))
    inp["cfg"]["esm_4"] = esm
    inp["cfg"]["esm_6"] = dataclasses.replace(esm, num_heads=6, num_kv_heads=6, d_model=192,
                                              head_dim=32)
    for name, cfg in inp["cfg"].items():
        key = jax.random.PRNGKey(1 if name.startswith("esm") else 0)
        inp["params"][name] = jax.device_get(build_model(cfg).init(key))
    inp["cfg"] = {k: dataclasses.asdict(v) for k, v in inp["cfg"].items()}
    return inp


def _reference_outputs(inp):
    """The reference's mesh-free engine's tokens and ``embed_pool``."""
    import jax.numpy as jnp

    from repro.core.config import ModelConfig
    from repro.models.model import build_model
    from repro.serving.engine import Engine, Request
    from repro.serving.sampling import SamplingParams

    want = {"tokens": {}, "embed": {}}
    for name, layouts in (("common", tuple(LAYOUTS)), ("replicated", REPLICATED_LAYOUTS)):
        cfg = ModelConfig(**inp["cfg"][name])
        model = build_model(cfg)
        for layout in layouts:
            eng = Engine(model, inp["params"][name], slots=3, max_len=64, **LAYOUTS[layout])
            for i, p in enumerate(prompts(cfg.vocab_size)):
                sp = None if i % 2 == 0 else SamplingParams(temperature=0.8, top_k=12,
                                                            seed=40 + i)
                eng.submit(Request(uid=i, prompt=p, max_new=8, params=sp))
            eng.run()
            want["tokens"][name, layout] = {r.uid: tuple(r.output) for r in eng.done}
    toks, lens = embed_batch()
    for name in ("esm_4", "esm_6"):
        model = build_model(ModelConfig(**inp["cfg"][name]))
        want["embed"][name] = np.asarray(model.embed_pool(
            inp["params"][name], {"tokens": jnp.asarray(toks)}, jnp.asarray(lens)))
    return want


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The children serve while this process runs the reference."""
    out = tmp_path_factory.mktemp("gloo4_serve")
    inp = _reference_inputs()
    with open(out / "inputs.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    logs = [open(out / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(out)], env=env,
                              stdout=logs[r], stderr=subprocess.STDOUT) for r in range(WORLD)]
    t0 = time.monotonic()
    try:
        inp.update(_reference_outputs(inp))
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
@pytest.mark.parametrize("mesh", list(PARITY_MESHES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_engine_gives_the_mesh_free_tokens(world, mesh, layout):
    inp, res = world
    want = inp["tokens"]["common", layout]
    assert res["free"]["common", layout] == want
    for rank, got in enumerate(res["parity"][mesh, layout]):
        assert got == want, (rank, got, want)


@pytest.mark.parametrize("layout", REPLICATED_LAYOUTS)
def test_replicated_kv_heads_give_the_mesh_free_tokens(world, layout):
    inp, res = world
    want = inp["tokens"]["replicated", layout]
    assert res["free"]["replicated", layout] == want
    for rank, got in enumerate(res["replicated"][layout]):
        assert got == want, (rank, got, want)
    # each rank caches one K/V head: its two query heads share it
    assert res["replicated_kv"] == [[0], [0], [1], [1]]


def test_one_host_transfer_per_decode_step_on_every_rank(world):
    _, res = world
    for rank, (transfers, decoded) in enumerate(res["transfers"]):
        assert decoded == [3, 3, 3] and transfers == 3, (rank, transfers, decoded)


def test_each_rank_pools_hold_its_kv_heads(world):
    _, res = world
    for rank, shapes in enumerate(res["shapes"]):
        assert shapes["k_pool"] == (2, 1 + 3 * 8, 8, 2, 8), (rank, shapes)
        assert shapes["dense_k"] == (2, 3, 64, 2, 8), (rank, shapes)
        assert shapes["block_table"] == (3, 8) and shapes["pos"] == (3,), (rank, shapes)
        assert shapes["heads"] == [2 * rank, 2 * rank + 1]


def test_pools_after_churn_equal_the_mesh_free_pools_head_slices(world):
    _, res = world
    churn = res["churn"]
    assert churn["tokens_equal"], churn
    assert churn["preempted"] > 0 and churn["cow_copies"] > 0 and churn["hit_tokens"] > 0, churn
    for rank, err in enumerate(churn["pool_err"]):
        assert err < 1e-5, (rank, err)
    assert churn["free_pages_equal"]


@pytest.mark.parametrize("case", ["head_tp", "context"])
def test_embeddings_on_a_mesh_match_the_reference(world, case):
    inp, res = world
    r = res["embed"][case]
    assert r["attention_parallelism"] == case
    want = inp["embed"][r["ref"]]
    for rank, got in enumerate(r["pool"]):
        assert np.abs(got - want).max() < 1e-5, (rank, np.abs(got - want).max())
    for rank, (got, free) in enumerate(zip(r["llm"], r["llm_free"])):
        assert np.abs(got - free).max() < 1e-5, rank


def test_skewed_clocks_agree_on_every_deadline(world):
    _, res = world
    reasons = res["clock"]["reasons"]
    assert all(r == reasons[0] for r in reasons), reasons
    assert {"timeout", "length"} <= set(reasons[0].values()), reasons[0]
    # the ranks' own clocks really ran apart
    assert len(set(res["clock"]["elapsed"])) == WORLD, res["clock"]["elapsed"]


@pytest.mark.parametrize("family", ["moe", "ssm"])
def test_moe_and_ssm_serve_on_data_ranks_as_the_mesh_free_model(world, family):
    _, res = world
    r = res["families"][family]
    for rank, got in enumerate(r["mesh"]):
        assert got == r["free"], (rank, got, r["free"])


@pytest.mark.parametrize("name", ["llama4-scout-17b-a16e", "mamba2-2.7b", "molmim-65m",
                                  "context-generation"])
def test_the_model_axis_refuses_what_it_does_not_serve(world, name):
    _, res = world
    item = "14e" if name == "context-generation" else "14b"
    assert f"item {item}" in res["refused"][name], res["refused"][name]


def test_the_launcher_serves_on_a_mesh_and_only_rank_0_prints(world):
    _, res = world
    outs = res["launcher"]
    assert "[paged] served 4/4 requests / 12 tokens on 3 slots" in outs[0], outs[0]
    assert "health:" in outs[0]
    assert all(o == "" for o in outs[1:]), outs[1:]


def test_the_serving_world_stays_cheap(world):
    _, res = world
    assert res["seconds"] < DEADLINE_S / 2, res["seconds"]


# --------------------------------------------------------------------- #
# the children (torch and the port only)
# --------------------------------------------------------------------- #
def _child(rank: int, out: Path) -> None:
    import contextlib
    import datetime
    import io

    import torch.distributed as dist

    from repro_torch.checkpoint.bridge import from_jax_params
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.config import ModelConfig, ParallelConfig
    from repro_torch.launch import serve as launch_serve
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models.model import Model, build_model
    from repro_torch.parallel.sharding import rank_kv_heads
    from repro_torch.serving import engine as engine_mod
    from repro_torch.serving.api import LLM
    from repro_torch.serving.engine import Engine, Request
    from repro_torch.serving.sampling import SamplingParams

    torch.set_num_threads(1)
    with open(out / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    dist.init_process_group("gloo", store=dist.FileStore(str(out / "store"), WORLD), rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=120))
    meshes = {}

    def mesh(shape):
        if shape not in meshes:
            meshes[shape] = make_test_mesh(shape, ("data", "model"))
        return meshes[shape]

    def gather(x):
        got = [None] * WORLD
        dist.all_gather_object(got, x)
        return got

    def submit_load(eng, vocab, max_new=8):
        for i, p in enumerate(prompts(vocab)):
            sp = None if i % 2 == 0 else SamplingParams(temperature=0.8, top_k=12, seed=40 + i)
            eng.submit(Request(uid=i, prompt=p, max_new=max_new, params=sp))

    def serve(model, layout, **kw):
        eng = Engine(model, slots=3, max_len=64, **LAYOUTS[layout], **kw)
        submit_load(eng, model.cfg.vocab_size)
        eng.run()
        return {r.uid: tuple(r.output) for r in eng.done}

    res = {"free": {}, "parity": {}, "replicated": {}, "embed": {}, "families": {},
           "refused": {}}
    cfgs = {name: ModelConfig(**inp["cfg"][name]) for name in ("common", "replicated")}

    def model_on(name, mesh_):
        return Model(cfgs[name], from_jax_params(inp["params"][name]), ParallelConfig(), mesh_)

    # parity, and with the K/V heads replicated
    for layout in LAYOUTS:
        res["free"]["common", layout] = serve(model_on("common", None), layout)
        for mname, shape in PARITY_MESHES.items():
            res["parity"][mname, layout] = gather(serve(model_on("common", mesh(shape)), layout))
    for layout in REPLICATED_LAYOUTS:
        res["free"]["replicated", layout] = serve(model_on("replicated", None), layout)
        m = model_on("replicated", mesh((1, 4)))
        res["replicated"][layout] = gather(serve(m, layout))
    res["replicated_kv"] = gather(rank_kv_heads(m.cfg, m.ctx))

    # one host transfer a steady decode step, on (2, 2) paged
    m = model_on("common", mesh((2, 2)))
    eng = Engine(m, slots=3, max_len=64, **LAYOUTS["paged"])
    for i, p in enumerate(prompts(64)[:3]):
        eng.submit(Request(uid=i, prompt=p, max_new=16))
    for _ in range(4):
        eng.step()

    def banned(*a, **k):
        raise AssertionError("host read of a tensor inside the decode step")

    saved = {n: getattr(torch.Tensor, n) for n in ("item", "tolist", "__bool__", "__int__",
                                                    "__float__", "__index__", "nonzero")}
    before = engine_mod.to_host.transfers
    try:
        for n in saved:
            setattr(torch.Tensor, n, banned)
        decoded = [eng.step() for _ in range(3)]
    finally:
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
    res["transfers"] = gather((engine_mod.to_host.transfers - before, decoded))

    # the rank's cache shapes, on (1, 4)
    m = model_on("common", mesh((1, 4)))
    eng = Engine(m, slots=3, max_len=64, **LAYOUTS["paged"])
    eng.submit(Request(uid=0, prompt=prompts(64)[0], max_new=2))
    dense = Engine(m, slots=3, max_len=64)
    dense.submit(Request(uid=0, prompt=prompts(64)[0], max_new=2))
    res["shapes"] = gather({
        "k_pool": tuple(eng.cache["layers"]["sub0"]["attn"]["k_pool"].shape),
        "dense_k": tuple(dense.cache["layers"]["sub0"]["attn"]["k"].shape),
        "block_table": tuple(eng.cache["block_table"].shape),
        "pos": tuple(eng.cache["pos"].shape),
        "heads": rank_kv_heads(m.cfg, m.ctx)})

    # churn: prefix sharing, copy-on-write and preemption in a tight pool
    rng = np.random.default_rng(11)
    pre = rng.integers(1, 64, size=16).astype(np.int32)
    load = [np.concatenate([pre, rng.integers(1, 64, size=n).astype(np.int32)])
            for n in (5, 9, 3)] + [pre.copy(), pre.copy(),
                                   rng.integers(1, 64, size=21).astype(np.int32)]

    def churn(model):
        eng = Engine(model, slots=3, max_len=64, cache_layout="paged", page_size=8, num_pages=10,
                     prefix_cache=True, prefill_chunk=8, preempt=True)
        for i, p in enumerate(load):
            sp = SamplingParams(temperature=0.8, top_k=12, seed=70 + i) if i % 2 else None
            eng.submit(Request(uid=i, prompt=p, max_new=12, params=sp))
        eng.run()
        return eng

    free = churn(model_on("common", None))
    m = model_on("common", mesh((1, 4)))
    eng = churn(m)
    heads = rank_kv_heads(m.cfg, m.ctx)
    err = 0.0
    for sub, d in eng.cache["layers"].items():
        for n in ("k_pool", "v_pool"):
            mine = d["attn"][n][:, 1:]
            ref = free.cache["layers"][sub]["attn"][n][:, 1:, :, heads]
            err = max(err, float((mine - ref).abs().max()))
    toks = {r.uid: tuple(r.output) for r in eng.done}
    st = eng.alloc.stats
    res["churn"] = dict(tokens_equal=toks == {r.uid: tuple(r.output) for r in free.done},
                        preempted=eng.counters["preempted"], cow_copies=st["cow_copies"],
                        hit_tokens=st["hit_tokens"], pool_err=gather(err),
                        free_pages_equal=eng.alloc.free_pages == free.alloc.free_pages)

    # ESM-2 embeddings: head-TP on (1, 4), and 6 heads (context parallelism)
    toks, lens = embed_batch()
    for case, name in (("head_tp", "esm_4"), ("context", "esm_6")):
        cfg = ModelConfig(**inp["cfg"][name])
        params = inp["params"][name]
        m = Model(cfg, from_jax_params(params), ParallelConfig(), mesh((1, 4)))
        f = Model(cfg, from_jax_params(params))
        got = m.embed_pool(torch.from_numpy(toks), torch.from_numpy(lens)).numpy()
        rows = [list(t[:n]) for t, n in zip(toks, lens)] + [[5, 6, 7] * 7]
        res["embed"][case] = dict(ref=name, attention_parallelism=m.pc.attention_parallelism,
                                  pool=gather(got),
                                  llm=gather(LLM(m, slots=2, max_len=32).embed(rows)),
                                  llm_free=[LLM(f, slots=2, max_len=32).embed(rows)] * WORLD)
        if case == "context":
            try:
                LLM(m, slots=2, max_len=32).generate([[5, 6, 7]], SamplingParams(max_new=2))
                res["refused"]["context-generation"] = ""
            except NotImplementedError as e:
                res["refused"]["context-generation"] = str(e)

    # deadlines: every rank's clock runs at its own rate
    ticks = [0.0]

    def clock():
        ticks[0] += 0.004 * (rank + 1)
        return ticks[0]

    m = model_on("common", mesh((1, 4)))
    eng = Engine(m, slots=2, max_len=64, clock=clock)
    for i, p in enumerate(prompts(64) * 2):
        eng.submit(Request(uid=i, prompt=p, max_new=8,
                           deadline_ms=(None, 60.0, 400.0, 150.0)[i % 4]))
    eng.run()
    res["clock"] = dict(reasons=gather({r.uid: r.finish_reason for r in eng.done}),
                        elapsed=gather(round(clock(), 6)))

    # MoE and SSM on (4, 1); the families the model axis does not split
    for fam, name in (("moe", "llama4-scout-17b-a16e"), ("ssm", "mamba2-2.7b")):
        cfg = get_smoke_config(name)
        f = build_model(cfg, device="cpu", seed=0)
        m = build_model(cfg, ParallelConfig(), mesh((4, 1)), device="cpu", seed=0)
        res["families"][fam] = dict(free=serve(f, "dense"), mesh=gather(serve(m, "dense")))
    for name in ("llama4-scout-17b-a16e", "mamba2-2.7b", "molmim-65m"):
        try:
            build_model(get_smoke_config(name), ParallelConfig(), mesh((2, 2)), device="cpu")
            res["refused"][name] = ""
        except NotImplementedError as e:
            res["refused"][name] = str(e)

    # the launcher on (2, 2)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        launch_serve.main(["--arch", "qwen2-7b", "--smoke", "--continuous", "--device", "cpu",
                           "--mesh", "2x2", "--cache-layout", "paged", "--page-size", "8",
                           "--prefix-cache", "--prefill-chunk", "16", "--requests", "4",
                           "--prompt-len", "16", "--gen", "3", "--batch", "3",
                           "--health-every", "0"])
    res["launcher"] = gather(buf.getvalue())

    if rank == 0:
        with open(out / "results.pkl", "wb") as f:
            pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _child(int(sys.argv[1]), Path(sys.argv[2]))
