"""The port's training data plane against the reference's: the sharded
store (each package reads the other's, byte-equal files), the synthetic
store, length buckets and the size-aware sampler (draws bit-equal,
uniform and composed with ``ClusterSampler``), cursors that cross between
the packages both ways, the bucketed MLM and CLM batches, the background
producer's contracts, the two repairs (``MLMBatches`` with a batch
sampler, ``ClusterSampler.__iter__``), and the trainer's bit-exact resume
through store, sampler and producer."""
import json
import os
import time

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import dataset as jax_dataset  # noqa: E402
from repro.data import pipeline as jax_pipeline  # noqa: E402
from repro.data import producer as jax_producer  # noqa: E402
from repro.data import sampler as jax_sampler  # noqa: E402
from repro.data import size_aware as jax_size_aware  # noqa: E402
from repro.data import store as jax_store  # noqa: E402
from repro_torch.core.config import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core.module import tree_leaves  # noqa: E402
from repro_torch.data import dataset, pipeline, producer, sampler, size_aware, store  # noqa: E402
from repro_torch.launch.train import make_batches  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.training.loop import Trainer  # noqa: E402

# the same modules, one namespace per package
PORT = dict(dataset=dataset, pipeline=pipeline, producer=producer, sampler=sampler,
            size_aware=size_aware, store=store)
REF = dict(dataset=jax_dataset, pipeline=jax_pipeline, producer=jax_producer,
           sampler=jax_sampler, size_aware=jax_size_aware, store=jax_store)


def _corpus(tmp_path, pkg=PORT, n=300, seed=1, shard_tokens=4096, name="store"):
    return pkg["dataset"].build_synthetic_protein_store(str(tmp_path / name), n=n, seed=seed,
                                                        shard_tokens=shard_tokens)


def _same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.keys() == y.keys() and all(np.array_equal(x[k], y[k]) for k in x)


# ------------------------------------------------------------ sharded store
def test_each_package_reads_the_others_store(tmp_path):
    port, _ = _corpus(tmp_path, PORT, name="port")
    ref, _ = _corpus(tmp_path, REF, name="ref")
    assert port.num_shards > 1
    for name in sorted(os.listdir(port.root)):          # the same bytes on disk
        with open(os.path.join(port.root, name), "rb") as f, \
                open(os.path.join(ref.root, name), "rb") as g:
            assert f.read() == g.read(), name
    for reader, root in ((store.ShardedTokenStore, ref.root),
                         (jax_store.ShardedTokenStore, port.root)):
        other = reader(root)
        assert len(other) == len(port) and other.num_shards == port.num_shards
        assert all(np.array_equal(other[i], port[i]) for i in range(len(port)))
        assert np.array_equal(other.lengths(), port.lengths())
        assert other.total_tokens == port.total_tokens
        assert [other.locate(i) for i in range(0, len(port), 7)] == \
            [port.locate(i) for i in range(0, len(port), 7)]
        assert other.shard_assignment(1, 3) == port.shard_assignment(1, 3)


def test_synthetic_store_matches_the_memmap_and_the_reference(tmp_path):
    st, _ = _corpus(tmp_path)
    mm, _ = dataset.build_synthetic_protein_memmap(str(tmp_path / "mm" / "p"), n=300, seed=1)
    ref, _ = _corpus(tmp_path, REF, name="ref")
    assert len(st) == len(mm) == len(ref)
    assert all(np.array_equal(st[i], mm[i]) and np.array_equal(st[i], ref[i])
               for i in range(len(st)))
    assert st.total_tokens == int(mm.lengths().sum())
    long, _ = dataset.build_synthetic_protein_store(str(tmp_path / "long"), n=16, seed=0,
                                                    min_len=100, max_len=1023)
    mm_long, _ = dataset.build_synthetic_protein_memmap(str(tmp_path / "mml"), n=16, seed=0,
                                                        min_len=100, max_len=1023)
    assert all(np.array_equal(long[i], mm_long[i]) for i in range(16))


def test_store_locate_manifest_and_validation(tmp_path):
    st, _ = _corpus(tmp_path)
    for i in range(0, len(st), 13):
        k, j = st.locate(i)
        assert int(st.cum_seqs[k]) + j == i and 0 <= j < st.shards[k]["sequences"]
    for bad in (len(st), -1):
        with pytest.raises(IndexError):
            st.locate(bad)
    # a writer that never finalizes leaves shards but no manifest
    root = str(tmp_path / "crash")
    w = store.ShardedStoreWriter(root, shard_tokens=64)
    for _ in range(20):
        w.add(np.arange(10, dtype=np.int32))
    assert any(f.endswith(".bin") for f in os.listdir(root)) and store.MANIFEST not in os.listdir(root)
    with pytest.raises(FileNotFoundError):
        store.ShardedTokenStore(root)
    assert len(w.finalize()) == 20
    with pytest.raises(RuntimeError):
        w.finalize()
    w2 = store.ShardedStoreWriter(str(tmp_path / "v"))
    with pytest.raises(ValueError):
        w2.add(np.empty((0,), np.int32))
    with pytest.raises(ValueError):
        w2.finalize()
    with pytest.raises(ValueError):
        store.ShardedStoreWriter(str(tmp_path / "z"), shard_tokens=0)
    path = os.path.join(st.root, store.MANIFEST)
    with open(path) as f:
        m = json.load(f)
    m["version"] = 99
    with open(path, "w") as f:
        json.dump(m, f)
    with pytest.raises(ValueError, match="version"):
        store.ShardedTokenStore(st.root)


def test_worker_readers_and_their_cursor_match_the_reference(tmp_path):
    st, _ = _corpus(tmp_path)
    ref = jax_store.ShardedTokenStore(st.root)
    W = 3
    assert sorted(s for w in range(W) for s in st.shard_assignment(w, W)) == list(range(st.num_shards))
    for w in range(W):
        a = [s.tobytes() for s in st.reader(worker=w, num_workers=W)]
        assert a == [s.tobytes() for s in ref.reader(worker=w, num_workers=W)]
    with pytest.raises(ValueError):
        st.shard_assignment(3, 3)
    r = st.reader(worker=1, num_workers=2)
    for _ in range(25):
        next(r)
    cur = json.loads(json.dumps(r.state_dict()))
    rest = [s.tobytes() for s in r]
    for make in (lambda: st.reader(worker=1, num_workers=2),
                 lambda: ref.reader(worker=1, num_workers=2)):
        r2 = make()
        r2.load_state_dict(cur)
        assert [s.tobytes() for s in r2] == rest
    assert len(st.reader(worker=1, num_workers=2)) == 25 + len(rest)


# ------------------------------------------------------------ size-aware batching
@pytest.mark.parametrize("max_len,min_len,growth", [(200, 16, 1.3), (1024, 16, 1.3), (64, 8, 1.5),
                                                    (16, 16, 1.3)])
def test_length_buckets_match_reference(max_len, min_len, growth):
    got = size_aware.length_buckets(max_len, min_len=min_len, growth=growth)
    assert np.array_equal(got, jax_size_aware.length_buckets(max_len, min_len=min_len, growth=growth))
    assert got[0] == min_len and got[-1] == max_len and (np.diff(got) > 0).all()
    if max_len == 1024:   # the ESM-2 phase's ten buckets from 102 tokens up
        assert got[np.searchsorted(got, 102):].tolist() == [110, 143, 186, 242, 315, 410, 533,
                                                           693, 901, 1024]
    for bad in (dict(max_len=4, min_len=8), dict(max_len=64, growth=1.0)):
        with pytest.raises(ValueError):
            size_aware.length_buckets(**bad)


def _sampler_pair(kind, lengths, budget=2048):
    def make(pkg):
        kw = dict(seed=9)
        if kind == "composed":
            kw["base"] = pkg["sampler"].ClusterSampler(
                pkg["sampler"].greedy_length_clusters(lengths, 8), seed=4)
        if kind == "round_to":
            kw["round_to"] = 4
        if kind == "boundaries":
            kw.update(boundaries=[64, 128, 256], draw_chunk=7)
        return pkg["size_aware"].SizeAwareSampler(lengths, budget, **kw)
    return make(PORT), make(REF)


@pytest.mark.parametrize("kind", ["uniform", "composed", "round_to", "boundaries"])
def test_size_aware_draws_bit_equal_to_reference(tmp_path, kind):
    lengths = _corpus(tmp_path)[0].lengths()
    port, ref = _sampler_pair(kind, lengths)
    assert np.array_equal(port.boundaries, ref.boundaries)
    assert np.array_equal(port.capacity, ref.capacity)
    round_to = 4 if kind == "round_to" else 1
    for _ in range(40):
        (i1, l1), (i2, l2) = port.sample_batch(), ref.sample_batch()
        assert l1 == l2 and np.array_equal(i1, i2)
        assert len(i1) * l1 <= 2048 and (lengths[i1] <= l1).all() and len(i1) % round_to == 0
    assert port.state_dict() == ref.state_dict()
    batches = iter(port)
    assert np.array_equal(next(batches)[0], ref.sample_batch()[0])


def test_size_aware_refusals_match_reference(tmp_path):
    for pkg in (size_aware, jax_size_aware):
        with pytest.raises(ValueError, match="cannot fit"):
            pkg.SizeAwareSampler([10, 200], 100)
        with pytest.raises(ValueError, match="exceeds the top bucket"):
            pkg.SizeAwareSampler([10, 300], 4096, boundaries=[64, 128])
        with pytest.raises(ValueError, match="empty"):
            pkg.SizeAwareSampler([], 4096)
    lengths = _corpus(tmp_path)[0].lengths()
    cur = size_aware.SizeAwareSampler(lengths, 2048).state_dict()
    with pytest.raises(ValueError, match="bucket"):
        size_aware.SizeAwareSampler(lengths, 2048, boundaries=[64, 256]).load_state_dict(cur)


def _stack(pkg, st, tok, kind, depth=3):
    """MLM or CLM batches over a size-aware sampler composed with a
    ClusterSampler, behind a background producer."""
    lengths = np.minimum(st.lengths(), 128)
    base = pkg["sampler"].ClusterSampler(pkg["sampler"].greedy_length_clusters(lengths, 8), seed=3)
    sas = pkg["size_aware"].SizeAwareSampler(lengths, 1024, base=base, seed=5)
    if kind == "mlm":
        pipe = pkg["pipeline"].MLMBatches(st, tok, sas, batch=8, seq_len=128, seed=2)
    else:
        pipe = pkg["pipeline"].CLMBatches(st, batch=8, seq_len=128, seed=2, sampler=sas)
    return pkg["producer"].BackgroundProducer(pipe, depth=depth)


@pytest.mark.parametrize("kind", ["mlm", "clm"])
def test_bucketed_batches_equal_the_reference(tmp_path, kind):
    st, tok = _corpus(tmp_path)
    ref_st = jax_store.ShardedTokenStore(st.root)
    with _stack(PORT, st, tok, kind) as a, _stack(REF, ref_st, tok, kind) as b:
        got = [next(a) for _ in range(12)]
        _same_batches(got, [next(b) for _ in range(12)])
    shapes = {x["tokens"].shape for x in got}
    assert len(shapes) > 1 and all(r * L <= 1024 and L <= 128 for r, L in shapes)
    if kind == "clm":
        for x in got:
            assert (x["tokens"][x["loss_mask"] == 0] == 0).all()


@pytest.mark.parametrize("direction", ["port_to_reference", "reference_to_port"])
def test_cursor_crosses_between_the_packages(tmp_path, direction):
    st, tok = _corpus(tmp_path)
    ref_st = jax_store.ShardedTokenStore(st.root)
    src, dst = (PORT, REF) if direction == "port_to_reference" else (REF, PORT)
    with _stack(src, st, tok, "mlm") as a:
        for _ in range(7):
            next(a)
        time.sleep(0.05)       # let the worker run ahead of the consumer
        cur = json.loads(json.dumps(a.state_dict()))     # as a checkpoint stores it
        want = [next(a) for _ in range(6)]
    assert cur["consumed"] == 7
    b = _stack(dst, ref_st if dst is REF else st, tok, "mlm")
    b.load_state_dict(cur)
    with b:
        _same_batches([next(b) for _ in range(6)], want)


# ------------------------------------------------------------ repairs
def test_mlm_batches_take_a_batch_sampler_as_the_reference(tmp_path):
    st, tok = _corpus(tmp_path)
    lengths = np.minimum(st.lengths(), 128)
    a = iter(pipeline.MLMBatches(st, tok, size_aware.SizeAwareSampler(lengths, 1024, seed=5),
                                 batch=8, seq_len=100))
    b = iter(jax_pipeline.MLMBatches(st, tok, jax_size_aware.SizeAwareSampler(lengths, 1024, seed=5),
                                     batch=8, seq_len=100))
    got = [next(a) for _ in range(10)]
    _same_batches(got, [next(b) for _ in range(10)])
    assert max(x["tokens"].shape[1] for x in got) == 100        # L = min(bucket, seq_len)
    assert all(x["tokens"].shape[0] * x["tokens"].shape[1] <= 1024 for x in got)


def test_cluster_sampler_iterates_as_the_reference():
    members = [[1, 2, 3], [4], [5, 6], [7, 8, 9, 10]]
    a = iter(sampler.ClusterSampler(members, seed=3))
    b = iter(jax_sampler.ClusterSampler(members, seed=3))
    got = [next(a) for _ in range(50)]
    assert got == [next(b) for _ in range(50)] and all(isinstance(i, int) for i in got)


# ------------------------------------------------------------ the producer
def _mlm(tmp_path, pkg=PORT, seed=9):
    mm, tok = pkg["dataset"].build_synthetic_protein_memmap(str(tmp_path / "mm" / "p"), n=200, seed=2)
    return pkg["pipeline"].MLMBatches(mm, tok, None, batch=4, seq_len=64, seed=seed)


def test_producer_keeps_the_reference_pipelines_order(tmp_path):
    bare = iter(_mlm(tmp_path, REF))
    with producer.BackgroundProducer(_mlm(tmp_path), depth=3) as prod:
        _same_batches([next(prod) for _ in range(12)], [next(bare) for _ in range(12)])


def test_producer_cursor_and_resume(tmp_path):
    with producer.BackgroundProducer(_mlm(tmp_path), depth=4) as prod:
        next(prod)
        time.sleep(0.3)           # the worker fills the queue well past the consumer
        cur = prod.state_dict()
        want = [next(prod) for _ in range(6)]
    assert cur["consumed"] == 1
    p2 = producer.BackgroundProducer(_mlm(tmp_path), depth=2)
    p2.load_state_dict(cur)
    with p2:
        _same_batches([next(p2) for _ in range(6)], want)
    assert p2.consumed == 7
    with pytest.raises(ValueError):
        producer.BackgroundProducer(_mlm(tmp_path), depth=0)


def test_producer_finite_stream_and_close(tmp_path):
    st, _ = _corpus(tmp_path, n=40, shard_tokens=512)
    prod = producer.BackgroundProducer(st.reader(), depth=2)
    with prod:
        assert len(list(prod)) == 40
    with pytest.raises(StopIteration):
        next(prod)
    prod.close()                                   # idempotent
    p2 = producer.BackgroundProducer(st.reader(), depth=2)
    with p2:
        next(p2)
    with pytest.raises(RuntimeError, match="closed"):
        next(p2)


def test_producer_reraises_a_worker_error():
    class Boom:
        def __iter__(self):
            yield {"x": 1}
            raise RuntimeError("poisoned shard")

    with producer.BackgroundProducer(Boom(), depth=2) as prod:
        assert next(prod) == {"x": 1}
        with pytest.raises(RuntimeError, match="poisoned shard"):
            next(prod)


def test_producer_close_unblocks_a_full_queue():
    def forever():
        while True:
            yield np.zeros((256,), np.int32)

    prod = producer.BackgroundProducer(forever(), depth=1)
    next(prod)
    time.sleep(0.2)                       # the worker is now blocked on the full queue
    t0 = time.perf_counter()
    prod.close()
    assert time.perf_counter() - t0 < 5.0 and prod._thread is None


def test_producer_refuses_a_late_restore(tmp_path):
    with producer.BackgroundProducer(_mlm(tmp_path), depth=2) as prod:
        cur = prod.state_dict()
        next(prod)
        with pytest.raises(RuntimeError, match="after iteration"):
            prod.load_state_dict(cur)


# ------------------------------------------------------------ full stack
def test_trainer_resume_bit_exact_full_data_plane(tmp_path):
    """Sharded store + size-aware sampler + background producer through the
    Trainer, interrupted at a checkpoint: the resumed run's final params and
    moments equal the uninterrupted run's bit for bit, the batches' (B, L)
    changing from step to step."""
    cfg = ModelConfig(name="dp-test", family="dense", num_layers=2, d_model=32, num_heads=2,
                      num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32", objective="mlm")
    tc = TrainConfig(global_batch=4, seq_len=128, learning_rate=1e-3, total_steps=8,
                     warmup_steps=2, decay_steps=2, log_every=2, ckpt_dir=str(tmp_path / "ck"),
                     ckpt_every=3)
    model = build_model(cfg, device="cpu")
    shapes = []

    def run(**kw):
        b = make_batches(cfg, tc, str(tmp_path / "data"), sharded=True, max_tokens=512,
                         producer_depth=2)
        tr = Trainer(model, tc, verbose=False)
        step_fn = tr._step_fn
        tr._step_fn = lambda st, batch: (shapes.append(tuple(batch["tokens"].shape)),
                                         step_fn(st, batch))[1]
        try:
            state, hist = tr.run(b, **kw)
        finally:
            b.close()
        return state.clone(), hist

    s1, h1 = run()
    assert len(set(shapes)) > 1 and all(r * L <= 512 for r, L in shapes)
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_3", "step_6", "step_8"]
    s2, h2 = run(resume_from=str(tmp_path / "ck" / "step_3"))
    assert shapes[8:] == shapes[3:8]          # the resumed run replays the same batches
    assert h2[-1]["loss"] == h1[-1]["loss"]
    for a, b in zip(tree_leaves(s1.params) + tree_leaves(s1.opt.mu) + tree_leaves(s1.opt.nu),
                    tree_leaves(s2.params) + tree_leaves(s2.opt.mu) + tree_leaves(s2.opt.nu)):
        assert torch.equal(a.detach(), b.detach())
    assert int(s1.opt.step) == int(s2.opt.step) == 8
