"""The port's C++ extraction engine (gmeta_tpu_torch.data.native, built by
g++ from gmeta_tpu_torch/csrc/extract.cpp) and its disk cache, against the
JAX package's engine and cache, and build_datasets of both packages over
one prepared dataset with the native engine.

Tests that build the engine skip with a reason where g++ is absent."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from gmeta_tpu.config import Config as JConfig
from gmeta_tpu.data import extract_cache as jcache
from gmeta_tpu.data import native as jnative
from gmeta_tpu.data.graph import CSRGraph as JCSRGraph
from gmeta_tpu.data.graph import synthetic_store
from gmeta_tpu.data.prepare import prepare_link, prepare_node_disjoint
from gmeta_tpu.run.train import build_datasets as j_build
from gmeta_tpu_torch.config import Config
from gmeta_tpu_torch.data import extract_cache, native
from gmeta_tpu_torch.data.extract import SubgraphExtractor
from gmeta_tpu_torch.data.graph import CSRGraph
from gmeta_tpu_torch.ops import cuda_build
from gmeta_tpu_torch.run.train import build_datasets

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def gxx():
    if not native.available():
        pytest.skip("g++ is absent: the port's native engine cannot be built")


@pytest.fixture
def jax_engine():
    if not jnative.available():
        pytest.skip("the JAX package's engine is not built (make -C native)")


def _graph(seed=0, n=300, m=2000):
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, n, m), rng.randint(0, n, m)
    return CSRGraph.from_edges(src, dst, n)


def _jgraph(g):
    return JCSRGraph(indptr=g.indptr, indices=g.indices)


def _assert_same(a, b):
    for f in ("parents", "centers", "edge_src", "edge_dst"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype, f
        np.testing.assert_array_equal(x, y, err_msg=f)


@pytest.mark.parametrize("kind", ["node", "link"])
@pytest.mark.parametrize("cap_strategy", ["uniform", "degree"])
def test_engine_bit_equal_to_jax_engine(gxx, jax_engine, cap_strategy, kind):
    """Same source, same content-derived RNG: capped and uncapped
    extractions of both engines agree bit for bit."""
    graphs = [_graph(seed=1, n=400, m=6000), _graph(seed=2, n=250, m=3000)]
    rng = np.random.RandomState(3)
    if kind == "node":
        names = [f"{g}_{i}" for g in (0, 1)
                 for i in rng.choice(graphs[g].num_nodes, 25, replace=False)]
    else:
        names = [f"{g}_{i}_{j}" for g in (0, 1)
                 for i, j in rng.randint(0, graphs[g].num_nodes, (12, 2))]
    for cap in (24, 10_000):           # capped for most names, then none
        kw = dict(h=2, sample_nodes=cap, seed=5, n_threads=3,
                  cap_strategy=cap_strategy)
        port = native.NativeSubgraphExtractor(graphs, **kw)
        ref = jnative.NativeSubgraphExtractor(
            [_jgraph(g) for g in graphs], **kw)
        subs = port.extract_many(names)
        if cap == 24:
            assert sum(s.num_nodes >= 24 for s in subs) > len(names) // 2
        for a, b in zip(subs, ref.extract_many(names)):
            _assert_same(a, b)


@pytest.mark.parametrize("h", [1, 2, 3])
def test_uncapped_equals_numpy_oracle(gxx, h):
    g = _graph()
    ref = SubgraphExtractor([g], h=h, sample_nodes=10_000)
    nat = native.NativeSubgraphExtractor([g], h=h, sample_nodes=10_000)
    for c in (0, 17, 123, 299):
        _assert_same(nat.extract(f"0_{c}"), ref.extract_node(0, c, f"0_{c}"))
    _assert_same(nat.extract("0_5_40"), ref.extract_link(0, 5, 40, "0_5_40"))


def test_engine_refuses_names_out_of_range(gxx):
    nat = native.NativeSubgraphExtractor([_graph(n=50, m=200)], h=2,
                                         sample_nodes=10)
    for bad in ("1_3", "0_50", "0_-1", "0_3_50"):
        with pytest.raises(ValueError):
            nat.extract(bad)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_cache_written_by_one_package_is_read_by_the_other(
        gxx, jax_engine, tmp_path, writer):
    store, _ = synthetic_store(2, 300, 6, 8, 3, seed=7)
    names = [f"{g}_{i}" for g in range(2) for i in range(0, 300, 17)]
    ex = native.NativeSubgraphExtractor(store.graphs, h=2, sample_nodes=64,
                                        seed=1)
    ex.extract_many(names)
    jex = jnative.NativeSubgraphExtractor(store.graphs, h=2, sample_nodes=64,
                                          seed=1)
    jex.extract_many(names)
    d = str(tmp_path)
    from gmeta_tpu.data.io import save_graphs_npz
    save_graphs_npz(os.path.join(d, "graphs.npz"), store.graphs)
    path = extract_cache.cache_path(d, 2, 64, "uniform")
    assert path == jcache.cache_path(d, 2, 64, "uniform")
    save, load, cache = ((extract_cache.save, jcache.load, ex.cache)
                         if writer == "port" else
                         (jcache.save, extract_cache.load, jex.cache))
    save(path, cache)
    loaded = load(path)
    assert sorted(loaded) == sorted(names)
    for n in names:
        _assert_same(loaded[n], ex.cache[n])
    # a fresh extractor warmed with half of what it read equals a cold one
    # on the other half (content-derived RNG)
    warm = native.NativeSubgraphExtractor(store.graphs, h=2, sample_nodes=64,
                                          seed=1)
    warm.cache.update({n: loaded[n] for n in names[:len(names) // 2]})
    for n in names[len(names) // 2:]:
        _assert_same(warm.extract(n), ex.cache[n])


def test_stale_paths_as_in_jax(tmp_path):
    d = str(tmp_path)
    files = [".extract_cache_h2_n64_uniform_100_aaaa.npz",
             ".extract_cache_h2_n64_uniform_200_bbbb.npz",
             ".extract_cache_h2_n64_degree_100_aaaa.npz",
             ".extract_cache_h1_n64_uniform_100_aaaa.npz",
             ".extract_cache_h2_n640_uniform_100_aaaa.npz"]
    for f in files:
        (tmp_path / f).write_bytes(b"")
    for current in files:
        cur = os.path.join(d, current)
        got = sorted(extract_cache.stale_paths(d, cur))
        assert got == sorted(jcache.stale_paths(d, cur))
    assert [os.path.basename(p) for p in extract_cache.stale_paths(
        d, os.path.join(d, files[0]))] == [files[1]]


def _node_dir(tmp_path):
    store, labels = synthetic_store(num_graphs=2, nodes_per_graph=150,
                                    avg_degree=6, feat_dim=8, num_classes=9,
                                    seed=0, class_signal=2.0)
    feats = [store.features[store.node_offsets[g]:store.node_offsets[g + 1]]
             for g in range(2)]
    out = str(tmp_path / "node")
    prepare_node_disjoint(out, store.graphs, feats, labels, num_label_set=3,
                          seed=0)
    return out, dict(task_setup="Disjoint", n_way=3, k_spt=2, k_qry=3, h=2,
                     sample_nodes=40, batchsz=8, eval_batchsz=4)


def _link_dir(tmp_path):
    rng = np.random.RandomState(0)
    n, pos, feats = 80, [], []
    for _ in range(5):
        a, b = rng.randint(0, n, 160), rng.randint(0, n, 160)
        pairs = np.unique(a[a < b] * n + b[a < b])
        pos.append(np.stack([pairs // n, pairs % n], 1))
        feats.append(rng.randn(n, 8).astype(np.float32))
    out = str(tmp_path / "link")
    prepare_link(out, pos, [n] * 5, feats, seed=0)
    return out, dict(task_setup="Shared", link_pred_mode=True, n_way=2,
                     k_spt=4, k_qry=4, h=2, sample_nodes=48, batchsz=8,
                     eval_batchsz=4)


def _assert_same_batches(jds, tds):
    for split in ("train", "val", "test"):
        jp, tp = jds[split].stacked_pool(), tds[split].stacked_pool()
        for a, b in zip(jp.spt + jp.qry, tp.spt + tp.qry):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset,extractor", [
    ("node", "native"), ("node", "auto"), ("link", "native")])
def test_build_datasets_bitwise_equal_to_jax(gxx, jax_engine, tmp_path,
                                             capsys, dataset, extractor):
    """Both packages' build_datasets on one prepared directory, with the
    C++ engine (asked for, or picked by `auto`), give bitwise-equal packed
    batches for every split; the port writes the disk cache, and a second
    port build read from it gives the same batches again."""
    out, flags = (_node_dir if dataset == "node" else _link_dir)(tmp_path)
    flags.update(data_dir=out, extractor=extractor)
    jstore, jds, jn = j_build(JConfig(**flags, extract_disk_cache=False))
    assert "extractor: native C++" in capsys.readouterr().out
    tstore, tds, tn = build_datasets(Config(**flags))
    said = capsys.readouterr().out
    assert f"extractor: native C++ (requested {extractor!r})" in said
    assert "extraction cache: wrote" in said
    assert jn == tn
    np.testing.assert_array_equal(jstore.features, tstore.features)
    _assert_same_batches(jds, tds)
    _, again, _ = build_datasets(Config(**flags))
    assert "extraction cache:" in capsys.readouterr().out
    _assert_same_batches(jds, again)


BUILD = """
import sys
from pathlib import Path
from gmeta_tpu_torch.ops import cuda_build
cuda_build.BUILD_DIR = Path(sys.argv[1])
so = cuda_build.build_host("extract")
lib = cuda_build.load_host("extract")
print("BUILT", so)
"""


def test_parallel_builds_share_one_library(gxx, tmp_path):
    """Six processes building the engine into one empty directory at once
    (as the test workers may) all load a whole library; no temporary file
    is left behind. The flags leave out -march=native."""
    assert "-march=native" not in cuda_build.HOST_FLAGS
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(6)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    built = {o[0].split("BUILT", 1)[1].strip() for o in outs}
    assert len(built) == 1
    assert sorted(f.name for f in tmp_path.iterdir()) == \
        [Path(built.pop()).name]
