"""The port's device extractor (gmeta_tpu_torch.data.device_extract) on the
CPU against the JAX package's DeviceExtractor and the host oracle, on the
graphs of tests/test_device_extract.py.

Uncapped extractions must be BIT-EQUAL to both (same sorted parent ids,
same induced edge list in the same emission order, same local centers).
Capped extractions cannot be bit-equal (different RNG streams), so they
are checked for the cap's invariants, as the JAX tests do."""

import numpy as np
import pytest
import torch

from gmeta_tpu.data.device_extract import DeviceExtractor as JDeviceExtractor
from gmeta_tpu.data.graph import synthetic_store
from gmeta_tpu_torch.data.device_extract import DeviceExtractor
from gmeta_tpu_torch.data.extract import SubgraphExtractor
from gmeta_tpu_torch.data.graph import CSRGraph

torch.set_num_threads(2)


def _random_graph(n=400, deg=6, seed=0):
    store, _ = synthetic_store(1, n, deg, 4, 3, seed)
    g = store.graphs[0]
    return CSRGraph(indptr=g.indptr, indices=g.indices)


def _assert_equal(a, b):
    for f in ("parents", "edge_src", "edge_dst", "centers"):
        x, y = getattr(a, f), getattr(b, f)
        np.testing.assert_array_equal(x, y, err_msg=f)
        assert x.dtype == y.dtype, (f, x.dtype, y.dtype)


@pytest.mark.parametrize("h", [1, 2])
def test_uncapped_bit_equal_to_jax_and_oracle(h):
    g = _random_graph()
    budgets = dict(set_cap=4096, hop_budget=16384, edge_budget=16384,
                   edge_out=8192)
    oracle = SubgraphExtractor([g], h=h, sample_nodes=10**6, seed=0)
    jdev = JDeviceExtractor(g, h=h, sample_nodes=g.num_nodes, **budgets)
    dev = DeviceExtractor(g, h=h, sample_nodes=g.num_nodes, device="cpu",
                          chunk=7, **budgets)
    centers = np.arange(0, g.num_nodes, 17)
    subs = dev.extract_batch(centers)
    jsubs = jdev.extract_batch(centers)
    assert len(subs) == len(centers)
    for c, sub, jsub in zip(centers, subs, jsubs):
        _assert_equal(sub, oracle.extract_node(0, int(c), f"0_{c}"))
        for f in ("parents", "edge_src", "edge_dst", "centers"):
            np.testing.assert_array_equal(getattr(sub, f), getattr(jsub, f))


def test_link_union_bit_equal_to_jax_and_oracle():
    g = _random_graph(n=300, deg=5, seed=1)
    budgets = dict(set_cap=2048, hop_budget=8192, edge_budget=8192,
                   edge_out=4096)
    oracle = SubgraphExtractor([g], h=2, sample_nodes=10**6, seed=0)
    jdev = JDeviceExtractor(g, h=2, sample_nodes=g.num_nodes, n_centers=2,
                            **budgets)
    dev = DeviceExtractor(g, h=2, sample_nodes=g.num_nodes, n_centers=2,
                          device="cpu", **budgets)
    pairs = np.array([[1, 7], [20, 33], [100, 5], [250, 251]])
    for (i, j), sub, jsub in zip(pairs, dev.extract_batch(pairs),
                                 jdev.extract_batch(pairs)):
        _assert_equal(sub, oracle.extract_link(0, int(i), int(j),
                                               f"0_{i}_{j}"))
        for f in ("parents", "edge_src", "edge_dst", "centers"):
            np.testing.assert_array_equal(getattr(sub, f), getattr(jsub, f))


def test_capped_invariants():
    g = _random_graph(n=800, deg=12, seed=2)
    cap = 64
    dev = DeviceExtractor(g, h=2, sample_nodes=cap, set_cap=2048,
                          hop_budget=32768, edge_budget=8192, edge_out=4096,
                          seed=7, device="cpu")
    full = SubgraphExtractor([g], h=2, sample_nodes=10**6, seed=0)
    centers = np.array([0, 13, 200, 555])
    arrays = dev.extract_arrays(centers)
    subs = dev.extract_batch(centers)
    for k, (c, sub) in enumerate(zip(centers, subs)):
        full_set = full.extract_node(0, int(c), f"0_{c}").parents
        assert len(full_set) > cap, "test graph must trigger the cap"
        assert int(arrays.n_full[k]) == len(full_set)
        assert sub.num_nodes == cap
        assert sub.parents[sub.centers[0]] == c        # center kept
        assert np.isin(sub.parents, full_set).all()    # subset of h-hop set
        # the induced edges are exactly the oracle's on the kept set
        src, dst = g.induced_edges(sub.parents)
        np.testing.assert_array_equal(sub.edge_src, src)
        np.testing.assert_array_equal(sub.edge_dst, dst)


def test_cap_is_uniform_over_noncenter_nodes():
    """Two seeds give different subsets, one seed gives the same; over
    many draws every non-center node of the set is kept about
    (cap - 1) / (n - 1) of the time."""
    g = _random_graph(n=800, deg=12, seed=3)
    kw = dict(set_cap=2048, hop_budget=32768, edge_budget=8192,
              edge_out=4096, device="cpu")

    def draw(seed, reps=1):
        ex = DeviceExtractor(g, h=2, sample_nodes=48, seed=seed, **kw)
        return ex.extract_batch(np.full(reps, 5))
    a, b, a2 = draw(1)[0], draw(2)[0], draw(1)[0]
    assert not np.array_equal(a.parents, b.parents)
    np.testing.assert_array_equal(a.parents, a2.parents)
    full = SubgraphExtractor([g], h=2, sample_nodes=10**6).extract_node(
        0, 5, "0_5").parents
    reps = 400
    counts = dict.fromkeys(full.tolist(), 0)
    for s in draw(3, reps):
        for v in s.parents.tolist():
            counts[v] += 1
    assert counts.pop(5) == reps
    p = 47 / (len(full) - 1)
    freq = np.array(list(counts.values())) / reps
    # every draw keeps exactly 47 non-centers, so the mean is exact; each
    # node's frequency is binomial, within 5 standard deviations of p
    sd = np.sqrt(p * (1 - p) / reps)
    assert abs(freq.mean() - p) < 1e-9
    assert np.abs(freq - p).max() < 5 * sd, (p, sd, freq.min(), freq.max())


def test_overflow_flag_raises():
    g = _random_graph(n=400, deg=8, seed=4)
    # hop_budget far below the 2-hop in-degree sum -> overflow flagged
    dev = DeviceExtractor(g, h=2, sample_nodes=32, set_cap=64,
                          hop_budget=16, edge_budget=256, edge_out=128,
                          device="cpu")
    assert bool(dev.extract_arrays(np.array([0])).overflow[0])
    with pytest.raises(OverflowError):
        dev.extract_batch(np.array([0]))


def test_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceExtractor(_random_graph(n=50, deg=4), h=2, sample_nodes=32)
