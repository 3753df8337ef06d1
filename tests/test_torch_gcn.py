"""The port's GCN (gmeta_tpu_torch.models.gcn) against the JAX package's
forward on the same packed batches and parameters."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gmeta_tpu.config import Config as JConfig
from gmeta_tpu.config import build_model_config as j_build
from gmeta_tpu.models import gcn as jgcn
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.data.extract import SubgraphExtractor
from gmeta_tpu_torch.data.graph import synthetic_store
from gmeta_tpu_torch.data.pack import TaskBatch, num_bins, pack_set, round_up
from gmeta_tpu_torch.meta.maml import batch_to
from gmeta_tpu_torch.models import gcn

torch.set_num_threads(2)


def _packed_tasks(link_pred, h, T=2, n_sub=5, seed=0):
    """T packed sets of n_sub subgraphs each, at one shared (B, P, E)."""
    store, _ = synthetic_store(num_graphs=2, nodes_per_graph=60,
                               avg_degree=6, feat_dim=8, seed=seed)
    ex = SubgraphExtractor(store.graphs, h=h, sample_nodes=40, seed=seed)
    rng = np.random.RandomState(seed)
    tasks = []
    for _ in range(T):
        subs, gidx = [], []
        for _ in range(n_sub):
            g = int(rng.randint(2))
            if link_pred:
                i, j = rng.choice(60, 2, replace=False)
                subs.append(ex.extract_link(g, int(i), int(j), f"{g}_{i}_{j}"))
            else:
                i = int(rng.randint(60))
                subs.append(ex.extract_node(g, i, f"{g}_{i}"))
            gidx.append(g)
        tasks.append((subs, gidx, rng.randint(0, 3, size=n_sub)))
    P = round_up(max(s.num_nodes for t in tasks for s in t[0]), 64)
    E = round_up(max(sum(s.num_edges for s in t[0]) for t in tasks), 128)
    B = max(num_bins([s.num_nodes for s in t[0]], P) for t in tasks)
    sets = [pack_set(subs, gidx, y, store, P, E, B=B)
            for subs, gidx, y in tasks]
    stacked = type(sets[0])(*(np.stack(xs) for xs in zip(*sets)))
    return store, sets, stacked


@pytest.mark.parametrize("agg", ["dense", "sized"])
@pytest.mark.parametrize("hidden", [4, 32])
@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("link_pred", [False, True])
def test_forward_matches_jax(link_pred, h, hidden, agg):
    """Node and link-pred tasks, depth 1-3, both matmul orders (hidden 4 <
    feat 8 projects first), both aggregations; f32 at rtol 1e-5."""
    store, sets, stacked = _packed_tasks(link_pred, h, seed=h)
    kw = dict(h=h, hidden_dim=hidden, link_pred_mode=link_pred,
              task_setup="Shared" if link_pred else "Disjoint")
    spec = build_model_config(Config(**kw), store.feat_dim, 3)
    assert spec == j_build(JConfig(**kw), store.feat_dim, 3)
    jparams = jgcn.init_params(jax.random.PRNGKey(h), spec)
    feats = jnp.asarray(store.features)
    want = np.stack([np.asarray(jgcn.forward(
        jparams, jax.tree.map(jnp.asarray, sg), feats, spec, agg=agg))
        for sg in sets])

    params = params_from_jax([np.asarray(p) for p in jparams])
    tb = batch_to(TaskBatch(spt=stacked, qry=stacked), "cpu").spt
    got = gcn.forward(params, tb, torch.from_numpy(store.features), spec,
                      agg=agg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # per-task parameter copies (the inner loop's fast weights) give the
    # same logits as shared ones
    per_task = tuple(p.unsqueeze(0).expand((2,) + p.shape) for p in params)
    np.testing.assert_allclose(
        gcn.forward(per_task, tb, torch.from_numpy(store.features), spec,
                    agg=agg).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("agg", ["dense", "sized"])
@pytest.mark.parametrize("hidden", [4, 32])
@pytest.mark.parametrize("h", [1, 2, 3])
@pytest.mark.parametrize("link_pred", [False, True])
def test_forward_bf16_matches_jax_bitwise(link_pred, h, hidden, agg):
    """The grid of test_forward_matches_jax in bf16: every GraphConv
    layer's activations (the `collect` hook) equal JAX's bit for bit, and
    the float32 logits match at float32's tolerance (the head's product
    sums in another order). Layer 1 runs in float32 in both packages: the
    masked input features are float32 (JAX's type promotion of the bf16
    rows times the float32 mask), so only its output is rounded."""
    store, sets, stacked = _packed_tasks(link_pred, h, seed=h)
    kw = dict(h=h, hidden_dim=hidden, link_pred_mode=link_pred,
              task_setup="Shared" if link_pred else "Disjoint")
    spec = build_model_config(Config(**kw), store.feat_dim, 3)
    jparams = jgcn.init_params(jax.random.PRNGKey(h), spec)
    feats = jnp.asarray(store.features)
    want, want_layers = [], [[] for _ in range(h)]
    for sg in sets:
        col = []
        want.append(np.asarray(jgcn.forward(
            jparams, jax.tree.map(jnp.asarray, sg), feats, spec,
            compute_dtype=jnp.bfloat16, agg=agg, collect=col)))
        for i, c in enumerate(col):
            want_layers[i].append(np.asarray(c).astype(np.float32))

    params = params_from_jax([np.asarray(p) for p in jparams])
    tb = batch_to(TaskBatch(spt=stacked, qry=stacked), "cpu").spt
    got_layers = []
    got = gcn.forward(params, tb, torch.from_numpy(store.features), spec,
                      compute_dtype=torch.bfloat16, agg=agg,
                      collect=got_layers)
    assert len(got_layers) == h
    for i, (w, g) in enumerate(zip(want_layers, got_layers)):
        assert g.dtype == torch.bfloat16, i
        np.testing.assert_array_equal(g.float().numpy(), np.stack(w),
                                      err_msg=f"layer {i + 1}")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("agg", ["dense", "sized"])
def test_precompute_bf16_keeps_h0_float32(agg):
    """In bf16 mode h0 is float32 holding bf16-rounded rows, pad slots
    zero, exactly as JAX's precompute(...).h0; the norm is bf16."""
    store, sets, stacked = _packed_tasks(False, 2, seed=5)
    tb = batch_to(TaskBatch(spt=stacked, qry=stacked), "cpu").spt
    feats = torch.from_numpy(store.features)
    ops = gcn.precompute(tb, torch.bfloat16, feats=feats, agg=agg)
    assert ops.h0.dtype == torch.float32 and ops.norm.dtype == torch.bfloat16
    assert torch.equal(ops.h0, gcn.gather_features(tb, feats,
                                                   torch.bfloat16))
    for t, sg in enumerate(sets):
        want = jgcn.precompute(jax.tree.map(jnp.asarray, sg), jnp.bfloat16,
                               feats=jnp.asarray(store.features)).h0
        assert want.dtype == jnp.float32
        np.testing.assert_array_equal(ops.h0[t].numpy(), np.asarray(want))
    assert torch.equal(ops.h0, ops.h0.to(torch.bfloat16).float())


class _Sizes(TorchDispatchMode):
    """Records the element count of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numels = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.numels += [t.numel() for t in
                        torch.utils._pytree.tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
        return out


def test_precompute_sized_builds_no_dense_adjacency():
    """agg="sized" builds the CSRs and degrees, and no tensor as large as
    one bin's P x P block; its norm equals the dense path's, and so do the
    logits."""
    store, sets, stacked = _packed_tasks(False, 2, seed=4)
    tb = batch_to(TaskBatch(spt=stacked, qry=stacked), "cpu").spt
    T, B, P = tb.node_gid.shape
    assert P * P > tb.edge_src.numel() and P * P > T * B * P + 1
    with _Sizes() as sizes:
        ops = gcn.precompute(tb, agg="sized")
    assert sizes.numels and max(sizes.numels) < P * P
    assert ops.A is None and ops.sized is not None
    dense = gcn.precompute(tb, agg="dense")
    assert dense.sized is None and dense.A.shape == (T * B, P, P)
    torch.testing.assert_close(ops.norm, dense.norm, rtol=0, atol=0)
    spec = build_model_config(Config(h=2, hidden_dim=16), store.feat_dim, 3)
    params = gcn.init_params(torch.Generator().manual_seed(0), spec)
    feats = torch.from_numpy(store.features)
    torch.testing.assert_close(
        gcn.forward(params, tb, feats, spec, graph=ops, agg="sized"),
        gcn.forward(params, tb, feats, spec, graph=dense, agg="dense"),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("input_dim,hidden,labels,link_pred,expected", [
    (128, 256, 3, False, 99_587),     # arxiv
    (50, 128, 2, False, 23_298),      # tissue_ppi
    (512, 128, 3, False, 82_563),     # fold_ppi
    (5, 128, 2, True, 17_794),        # firstmm_db
    (1, 256, 2, True, 67_330),        # tree_of_life
])
def test_param_counts_match_reference(input_dim, hidden, labels, link_pred,
                                      expected):
    """The reference's printed model sizes (tests/test_gcn.py:100-118)."""
    cfg = Config(h=2, hidden_dim=hidden, link_pred_mode=link_pred,
                 task_setup="Shared" if link_pred else "Disjoint")
    spec = build_model_config(cfg, input_dim, labels)
    params = gcn.init_params(torch.Generator().manual_seed(0), spec)
    assert gcn.count_params(params) == expected


def test_init_laws_and_jax_round_trip():
    spec = build_model_config(Config(h=2, hidden_dim=64), 32, 3)
    params = gcn.init_params(torch.Generator().manual_seed(1), spec)
    jparams = jgcn.init_params(jax.random.PRNGKey(1), spec)
    assert [tuple(p.shape) for p in params] == [p.shape for p in jparams]
    w0 = params[0]
    bound = (6.0 / (32 + 64)) ** 0.5                  # xavier-uniform
    assert w0.abs().max() <= bound and w0.abs().max() > 0.9 * bound
    assert not params[1].any() and not params[3].any() and not params[5].any()
    std = params[4].std().item()                      # kaiming-normal
    assert 0.7 * (2.0 / 64) ** 0.5 < std < 1.3 * (2.0 / 64) ** 0.5
    back = params_from_jax([p.numpy() for p in params])
    for a, b in zip(back, params):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    module = gcn.GCN(params)
    assert all(a is b for a, b in zip(module.flat(), module.params))
    assert gcn.count_params(module.flat()) == sum(
        int(np.prod(p.shape)) for p in jparams)
