"""The port's Graphormer (gmeta_tpu_torch/models/graphormer.py,
ops/spatial_attention.py) against the plain reference of
tests/graphormer_reference.py on seeded random weights, over tiny packed
sets with duplicate edges, a graph that falls apart, pad slots and two
tasks: the layers and the logits in the slot layout and repacked, the
distances and degrees, the op's backward by gradcheck, the meta-step, the
configuration's refusals, the spans, the Trainer and its CLI, the
one-subgraph-a-bin placement, and the GCN's and the GAT's bits unchanged.
CPU; imports neither jax nor the JAX package."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphormer_reference import Reference
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data import repack
from gmeta_tpu_torch.data.pack import (SubgraphSet, TaskBatch, ffd_bins,
                                       pack_set, stack_tasks)
from gmeta_tpu_torch.data.pipeline import SplitGeometry, agg_for, one_per_bin
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta import maml
from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to
from gmeta_tpu_torch.models import gat, gcn, graphormer, module_for
from gmeta_tpu_torch.ops import spatial_attention as sa
from gmeta_tpu_torch.run import train as train_mod
from gmeta_tpu_torch.utils import metrics

torch.set_num_threads(2)

FEAT, ROWS, LABELS = 5, 40, 2
# (layers, hidden, heads, ffn)
WIDTHS = {"2x8h2": (2, 8, 2, 6), "1x12h3": (1, 12, 3, 10)}
# float32 against the reference's per-graph dense products: the same sums
# in another order (the program's batched matmuls over padded windows)
RTOL, ATOL = 1e-5, 1e-5


def _cfg(widths, **kw):
    L, H, K, F = WIDTHS[widths]
    return Config(arch="graphormer", graphormer_layers=L,
                  graphormer_hidden=H, graphormer_heads=K,
                  graphormer_ffn=F, **kw)


def _ref_cfg(cfg: Config, update_step=2) -> dict:
    return {"feat_dim": FEAT, "graphormer_layers": cfg.graphormer_layers,
            "graphormer_hidden": cfg.graphormer_hidden,
            "graphormer_heads": cfg.graphormer_heads,
            "graphormer_ffn": cfg.graphormer_ffn, "labels_num": LABELS,
            "update_lr": 0.05, "update_step": update_step, "meta_lr": 0.01}


def _tiny_set(rng, T=2, B=2, P=8, fill=(6, 5), E=40, S=4) -> SubgraphSet:
    """T tasks' packed sets, one graph a bin: B bins of P slots, `fill`
    live slots a bin, random real edges within bins (bin 0's slots 0 and
    1 have none: its graph falls apart), two duplicated, sorted by
    destination, then pad edges (src 0, dst B*P-1, mask 0) as the packer
    leaves them."""
    node_gid = np.zeros((T, B, P), np.int32)
    node_mask = np.zeros((T, B, P), np.float32)
    src = np.zeros((T, E), np.int32)
    dst = np.full((T, E), B * P - 1, np.int32)
    mask = np.zeros((T, E), np.float32)
    centers = np.zeros((T, S, 2), np.int32)
    for t in range(T):
        edges = []
        for b, f in enumerate(fill):
            node_gid[t, b, :f] = rng.randint(0, ROWS, f)
            node_mask[t, b, :f] = 1
            lo = 2 if b == 0 else 0        # slots 0, 1 of bin 0: isolated
            for _ in range(2 * f):
                edges.append((b * P + rng.randint(lo, f),
                              b * P + rng.randint(lo, f)))
        edges += edges[:2]                 # duplicate edge slots
        edges.sort(key=lambda e: e[1])
        n = len(edges)
        src[t, :n], dst[t, :n] = np.array(edges).T
        mask[t, :n] = 1
        for k in range(S):
            b = k % B
            centers[t, k] = b * P + rng.randint(0, fill[b])
        centers[t, 0] = 0                  # an isolated node is a centre
    labels = np.tile(np.arange(S) % LABELS, (T, 1)).astype(np.int32)
    return SubgraphSet(node_gid, node_mask, src, dst, mask, centers, labels,
                       np.tile(np.array(fill, np.int32), (T, 1)))


def _task(sg: SubgraphSet, t: int) -> dict:
    return {k: v[t] for k, v in sg._asdict().items()}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(ROWS, FEAT).astype(np.float32))
    return feats, _tiny_set(rng), _tiny_set(rng, P=8, fill=(7, 4), S=6)


def _params(cfg: Config, seed=0):
    """Theta with the published init, then every leaf moved off it, so
    that every term of the layers matters (the biases and tables off
    zero, the LayerNorms off one)."""
    spec = build_model_config(cfg, FEAT, LABELS)
    gen = torch.Generator().manual_seed(seed)
    params = [p + 0.3 * torch.randn(p.shape, generator=gen)
              for p in graphormer.init_params(gen, spec)]
    return spec, params


def _repacked(sg: SubgraphSet):
    """The set repacked as the CSR path runs it, with its segments."""
    M = repack.bin_rows(repack.live_counts(sg.bin_fill))
    dev = batch_to(TaskBatch(sg, sg), "cpu").spt
    return (repack.repack(dev, M, repack.live_counts(sg.bin_fill)),
            repack.segments(dev.bin_fill, M, sg.bin_fill))


def _program_layers(params, spec, sg, feats, layout):
    """Logits and each layer's live rows (T, n_live, H) of the program, in
    the slot layout or repacked."""
    dev = batch_to(TaskBatch(sg, sg), "cpu").spt
    segs = None
    if layout == "repacked":
        dev, segs = _repacked(sg)
    graph = graphormer.precompute(dev, feats=feats, segments=segs)
    collect = []
    logits = graphormer.forward(params, dev, feats, spec, graph=graph,
                                collect=collect)
    T = dev.node_gid.shape[0]
    live = dev.node_mask.reshape(T, -1) != 0
    return logits, [h.reshape(T, live.shape[1], -1)[live].view(
        T, -1, h.shape[-1]) for h in collect]


@pytest.mark.parametrize("layout", ["slot", "repacked"])
@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_layers_and_logits_match_the_reference(inputs, widths, layout):
    feats, spt, _ = inputs
    cfg = _cfg(widths)
    spec, params = _params(cfg)
    got, layers = _program_layers(params, spec, spt, feats, layout)
    ref = Reference(_ref_cfg(cfg))
    for t in range(spt.node_gid.shape[0]):
        s = _task(spt, t)
        g = ref.graph(s, torch.device("cpu"))
        want = ref.logits(params, s, feats, g)
        torch.testing.assert_close(got[t], want, rtol=RTOL, atol=ATOL)
        by_bin = {b: [h[gi] for h in hs]
                  for bins, hs in ref.embed(params, s, feats, g)
                  for gi, b in enumerate(bins.tolist())}
        for li in range(cfg.graphormer_layers + 1):
            rows = torch.cat([by_bin[b][li] for b in sorted(by_bin)])
            torch.testing.assert_close(layers[li][t], rows, rtol=RTOL,
                                       atol=ATOL, msg=f"layer {li}")


def test_distances_and_degrees(inputs):
    """phi is the BFS distance over edges taken both ways; a bin whose
    graph falls apart gives its unreachable pairs byte 255, the table's
    row 511; degrees count each real edge slot, duplicates included."""
    _, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    g = sa.spatial_graph(sg.edge_src, sg.edge_dst, sg.edge_mask,
                         sg.node_mask, 2, 8)
    assert g.per_task == 2 and g.rows == 8 and g.stride == 64
    ref = Reference(_ref_cfg(_cfg("2x8h2")))
    phi = g.phi.view(-1, 64, 64)
    for t in range(2):
        groups, _ = ref.graph(_task(spt, t), torch.device("cpu"))
        for bins, slots, rows, d_in, d_out in groups:
            for gi, b in enumerate(bins.tolist()):
                n = slots.shape[1]
                tile = sa.table_row(phi[2 * t + b, :n, :n])
                assert torch.equal(tile, rows[gi])
                first = (t * 2 + b) * 8
                assert torch.equal(g.deg_in[first:first + n], d_in[gi])
                assert torch.equal(g.deg_out[first:first + n], d_out[gi])
    # bin 0's slots 0 and 1 have no edge: no path to anything else
    tile0 = phi[0]
    assert int(tile0[0, 0]) == 0 and int(tile0[0, 1]) == sa.NO_PATH
    assert int(tile0[1, 3]) == sa.NO_PATH
    assert int(sa.table_row(tile0[0, 1:2])) == 511
    src, dst = spt.edge_src[0][spt.edge_mask[0] != 0], \
        spt.edge_dst[0][spt.edge_mask[0] != 0]
    assert int(g.deg_in[:16].sum()) == len(dst)
    assert int(g.deg_out[:16].sum()) == len(src)


def test_a_pad_slot_reaches_no_live_row(inputs):
    """Pad slots attend only to themselves and are no live row's key: a
    change to a pad slot's q, k or v leaves every live row's output as it
    was, and a pad row's output is its own v."""
    feats, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    g = sa.spatial_graph(sg.edge_src, sg.edge_dst, sg.edge_mask,
                         sg.node_mask, 2, 8)
    K, D = 2, 3
    gen = torch.Generator().manual_seed(1)
    qkv = torch.randn(32, 3 * K * D, generator=gen)
    table = torch.randn(2, sa.TABLE_ROWS, K, generator=gen)
    o = sa.attend(g, qkv, table, K, D)
    pad = g.live == 0
    assert int(pad.sum()) == 2 * (2 + 3)
    moved = qkv.clone()
    moved[pad] += 100.0
    o2 = sa.attend(g, moved, table, K, D)
    assert torch.equal(o[~pad], o2[~pad])
    torch.testing.assert_close(o2[pad], moved[pad][:, 2 * K * D:])


@pytest.mark.parametrize("K,D", [(2, 3), (3, 2)])
def test_gradcheck_of_the_plain_attention_in_float64(inputs, K, D):
    """The plain backward (bwd_plain, the kernels' formulas) against
    numerical differences, the gradient of the spatial table included."""
    _, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    g = sa.spatial_graph(sg.edge_src, sg.edge_dst, sg.edge_mask,
                         sg.node_mask, 2, 8)
    gen = torch.Generator().manual_seed(K)
    qkv = torch.randn(32, 3 * K * D, generator=gen,
                      dtype=torch.float64).requires_grad_()
    table = torch.randn(2, sa.TABLE_ROWS, K, generator=gen,
                        dtype=torch.float64).requires_grad_()
    assert torch.autograd.gradcheck(
        lambda q, t: sa.attend(g, q, t, K, D), (qkv, table), eps=1e-6,
        atol=1e-6)


def test_the_backward_is_first_order_only(inputs):
    _, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    g = sa.spatial_graph(sg.edge_src, sg.edge_dst, sg.edge_mask,
                         sg.node_mask, 2, 8)
    qkv = torch.randn(32, 18, requires_grad=True)
    out = sa.attend(g, qkv, torch.zeros(2, 512, 2), 2, 3).sum()
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(out, qkv, create_graph=True)


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_train_steps_match_first_order_protomaml(inputs, widths):
    """Two MetaLearner.train_step calls (host batches: repacked, with
    their segments) against the reference's two meta-steps from the same
    theta: both meta-losses, the first meta-gradient as Adam holds it,
    theta after both."""
    feats, spt, qry = inputs
    cfg = _cfg(widths)
    spec, theta0 = _params(cfg, seed=3)
    ml = MetaLearner(spec, LABELS, update_lr=0.05, meta_lr=0.01,
                     update_step=2, update_step_test=2, seed=0, agg="sized",
                     device="cpu")
    ml.set_params(theta0)
    ml.set_features(feats.numpy())
    batch = TaskBatch(spt, qry)
    swapped = TaskBatch(SubgraphSet(*(x[::-1].copy() for x in spt)),
                        SubgraphSet(*(x[::-1].copy() for x in qry)))
    loss1 = float(ml.train_step(batch)["meta_loss"])
    grad1 = [m / (1 - 0.9) for m in ml.opt_state.mu]
    loss2 = float(ml.train_step(swapped)["meta_loss"])
    T = spt.node_gid.shape[0]
    steps = [[(_task(b.spt, t), _task(b.qry, t)) for t in range(T)]
             for b in (batch, swapped)]
    ref = Reference(_ref_cfg(cfg)).run(theta0, steps, feats)
    np.testing.assert_allclose(loss1, ref["losses"][0], rtol=1e-5)
    # the second loss is taken after Adam's first step, which moves each
    # parameter whose gradient is rounding noise (below) by a full step of
    # the noise's sign; these move the loss at 1e-5
    np.testing.assert_allclose(loss2, ref["losses"][1], rtol=1e-4)
    scale = max(float(g.abs().max()) for g in ref["grad1"])
    for i, (got, want) in enumerate(zip(grad1, ref["grad1"])):
        # float32 sums over tasks, pairs and rows in another order
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5 * scale,
                                   msg=f"grad of leaf {i}")
    # Adam moves a parameter whose gradient is rounding noise by the sign
    # of that noise (the head's bias: the prototype loss does not see a
    # shift of every centre alike); entries below 1e-4 of the largest
    # first gradient are left out
    floor = 1e-4 * scale
    for i, (got, want) in enumerate(zip(ml.params, ref["theta"])):
        real = ref["grad1"][i].abs() > floor
        torch.testing.assert_close(got.detach()[real], want[real],
                                   rtol=1e-5, atol=1e-5, msg=f"theta {i}")


def test_build_model_config_gives_graphormer_slim():
    cfg = Config(arch="graphormer").validate()
    assert (cfg.graphormer_layers, cfg.graphormer_hidden,
            cfg.graphormer_heads, cfg.graphormer_ffn) == (12, 80, 8, 80)
    spec = build_model_config(cfg, 50, 2)
    assert spec == ((("GraphormerEmbed", (50, 80, 8)),)
                    + (("GraphormerLayer", (80, 8, 80)),) * 12
                    + (("LayerNorm", (80,)), ("Linear", (80, 2))))
    assert module_for(spec) is graphormer and one_per_bin(spec)
    assert not one_per_bin(build_model_config(Config(), 50, 2))
    params = graphormer.init_params(torch.Generator().manual_seed(0), spec)
    assert len(params) == 5 + 12 * 12 + 4
    assert sum(p.numel() for p in params) == 560_818
    assert float(params[0].std()) == pytest.approx(0.02, rel=0.1)
    assert torch.equal(params[5], torch.ones(80))
    assert float(params[-2].std()) == pytest.approx((2 / 80) ** 0.5,
                                                    rel=0.3)


@pytest.mark.parametrize("field,value,what", [
    ("agg", "dense", "agg='dense'"),
    ("dtype", "bfloat16", "dtype 'bfloat16'"),
    ("link_pred_mode", True, "link prediction"),
    ("first_order", False, "second-order"),
    ("mesh_edges", 2, "edge engine"),
    ("mesh_tasks", 2, "task-DP"),
    ("graphormer_heads", 3, "no multiple of graphormer_heads"),
])
def test_validate_refuses_what_graphormer_lacks(field, value, what):
    kw = {"task_setup": "Shared"} if field == "link_pred_mode" else {}
    if field.startswith("mesh"):
        with pytest.raises(ValueError, match=what):
            Config(arch="graphormer", **kw).validate(**{field: value})
        return
    with pytest.raises(ValueError, match=what):
        Config(arch="graphormer", **{field: value}, **kw).validate()


def test_auto_is_the_csr_path_on_every_device():
    geo = SplitGeometry(1024, 6, 51200, 1024, 16, 141312, 135909.0, 0.5726)
    spec = build_model_config(Config(arch="graphormer"), 50, 2)
    for device in ("cpu", "cuda"):
        assert agg_for(geo, torch.device(device), spec) == "sized"


def test_set_params_refuses_another_models_theta():
    spec, theta = _params(_cfg("2x8h2"))
    ml = MetaLearner(spec, LABELS, update_lr=0.05, meta_lr=0.01,
                     update_step=1, update_step_test=1, device="cpu")
    gat_spec = build_model_config(Config(arch="gat", gat_heads=2,
                                         gat_hidden=4, gat_out_heads=2,
                                         gat_out_dim=3), FEAT, LABELS)
    for other in (build_model_config(Config(hidden_dim=8), FEAT, LABELS),
                  gat_spec):
        theta_other = module_for(other).init_params(
            torch.Generator().manual_seed(0), other)
        with pytest.raises(ValueError, match="theta has leaves"):
            ml.set_params(theta_other)
    ml.set_params(theta)


def test_sattn_and_spd_spans_wrap_every_call(inputs):
    """Under a profiler each attention call and each of its backwards is
    an `sattn` span, and each set's distances an `spd` span inside
    `graph`: L layers x (support: 3 forwards, 3 backwards; query: 3
    forwards, 1 backward) at update_step 2, and one `spd` a set."""
    feats, spt, qry = inputs
    cfg = _cfg("2x8h2")
    spec, theta0 = _params(cfg)
    ml = MetaLearner(spec, LABELS, update_lr=0.05, meta_lr=0.01,
                     update_step=2, update_step_test=2, seed=0, agg="sized",
                     device="cpu")
    ml.set_params(theta0)
    ml.set_features(feats.numpy())
    batch = TaskBatch(spt, qry)
    want = ml.train_step(batch)["meta_loss"]
    ml.set_params(theta0)
    metrics.clear_spans()
    with metrics.counted() as c:
        with profile(activities=[ProfilerActivity.CPU]):
            got = ml.train_step(batch)["meta_loss"]
    window = metrics.spans()
    assert torch.equal(got, want)
    sattn = [s for s in window if s.name == "sattn"]
    assert len(sattn) == cfg.graphormer_layers * ((3 + 3) + (3 + 1))
    assert all(s.parent < 0 or window[s.parent].name != "sattn"
               for s in sattn)
    spd = [s for s in window if s.name == "spd"]
    assert len(spd) == 2
    assert all(window[s.parent].name == "graph" for s in spd)
    # the pairs: each repacked set's segments' rows squared
    pairs = sum(int(np.square(repack.segments(
        torch.as_tensor(sg.bin_fill), repack.bin_rows(
            repack.live_counts(sg.bin_fill)), sg.bin_fill).lengths).sum())
        for sg in batch)
    assert c[sa.PAIRS] == pairs
    # each task: support 6, 5 and a pad piece of 5; query 7, 4 and 5
    assert pairs == 2 * (6 ** 2 + 5 ** 2 + 5 ** 2 + 7 ** 2 + 4 ** 2 + 5 ** 2)


def _fit_args(pool: bool):
    return ["--arch", "graphormer", "--graphormer_layers", "2",
            "--graphormer_hidden", "8", "--graphormer_heads", "2",
            "--graphormer_ffn", "6", "--epoch", "2", "--task_num", "4",
            "--update_step", "2", "--update_step_test", "2",
            "--update_lr", "0.05", "--n_way", "3", "--k_spt", "3",
            "--k_qry", "4", "--train_result_report_steps", "1",
            "--device_task_pool", str(pool), "--device", "cpu"]


@pytest.mark.parametrize("pool", [False, True])
def test_cli_trains_a_graphormer_through_the_trainer(monkeypatch, pool):
    """run/train.py's main builds a Graphormer from --arch graphormer
    alone and fits it for two epochs through the Trainer (streamed, or
    from the compact resident pool), one subgraph a bin, `auto` resolving
    to the CSR path."""
    store, ds = synthetic_disjoint(
        num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=FEAT,
        num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=8, h=2,
        sample_nodes=64, seed=3)
    built = {}

    class Spy(train_mod.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built["trainer"] = self

    monkeypatch.setattr(train_mod, "build_datasets",
                        lambda cfg: (store, ds, 3))
    monkeypatch.setattr(train_mod, "Trainer", Spy)
    res = train_mod.main(_fit_args(pool))
    tr = built["trainer"]
    assert tr.cfg.arch == "graphormer" and tr.agg == "sized"
    assert tr.spec[0][0] == "GraphormerEmbed"
    assert len(tr.learner.params) == 5 + 2 * 12 + 4
    assert all(d.one_per_bin for d in ds.values())
    assert tr.buckets["B_spt"] == 9 and tr.buckets["B_qry"] == 12
    assert res.epochs_run == 2 and res.global_step == 4
    assert np.isfinite(res.test_acc_final)


def test_one_subgraph_a_bin_and_ffd_unchanged():
    """A Graphormer's datasets hold one subgraph a bin (B the sets'
    subgraph counts); a GCN's and a GAT's keep FFD's bins, the same bytes
    as pack_set gives with FFD's assignment."""
    store, ds = synthetic_disjoint(
        num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=FEAT,
        num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=6, h=2,
        sample_nodes=64, seed=3)
    tr = ds["train"]
    ffd = (tr.B_spt, tr.B_qry)
    base = tr.stacked_pool()
    for arch in ("gcn", "gat"):
        spec = build_model_config(Config(arch=arch), FEAT, 3)
        tr.place_one_per_bin(one_per_bin(spec))
        assert (tr.B_spt, tr.B_qry) == ffd
        again = tr.stacked_pool()
        assert all(np.array_equal(a, b) for x, y in zip(base, again)
                   for a, b in zip(x, y))
    want = stack_tasks([TaskBatch(
        pack_set(t.spt_subs, t.spt_graphs, t.spt_labels, store, tr.P_spt,
                 tr.E_spt, B=tr.B_spt),
        pack_set(t.qry_subs, t.qry_graphs, t.qry_labels, store, tr.P_qry,
                 tr.E_qry, B=tr.B_qry)) for t in tr.tasks])
    assert all(np.array_equal(a, b) for x, y in zip(base, want)
               for a, b in zip(x, y))
    assert ffd[0] < 9 and ffd[1] < 12      # FFD shares bins
    tr.place_one_per_bin(True)
    assert (tr.B_spt, tr.B_qry) == (9, 12)
    pool = tr.stacked_pool()
    for sg, sets in ((pool.spt, [t.spt_subs for t in tr.tasks]),
                     (pool.qry, [t.qry_subs for t in tr.tasks])):
        for i, subs in enumerate(sets):
            sizes = [s.num_nodes for s in subs]
            assert list(sg.bin_fill[i]) == sizes
            assert list(sg.centers[i, :, 0] // sg.node_gid.shape[-1]) == \
                list(range(len(subs)))
    assert ffd_bins([3, 5, 2], 8) != list(range(3))
    tr.place_one_per_bin(False)
    assert (tr.B_spt, tr.B_qry) == ffd


def _parent_segments(bin_fill, M, fills):
    """data/repack.py `segments` as it was before the host's lengths."""
    fills = np.asarray(fills, dtype=np.int64)
    rows = max(int(fills.max(initial=0)), 1)
    pad = M - int(fills.sum(axis=-1).min(initial=M))
    fill = bin_fill.to(torch.int32)
    end = torch.cumsum(fill, dim=1, dtype=torch.int32)
    start = [end - fill]
    if pad > 0:
        start.append(end[:, -1:] + rows * torch.arange(
            -(-pad // rows), device=fill.device, dtype=torch.int32))
    return repack.Segments(torch.cat(start, dim=1).clamp_(max=M), rows)


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_gcn_and_gat_steps_keep_their_bits(inputs, arch, monkeypatch):
    """A GCN's and a GAT's meta-steps (repacked, the GAT with its
    segments) give the bits they gave with the parent's segments."""
    feats, spt, qry = inputs
    cfg = Config(arch=arch, hidden_dim=6, gat_heads=2, gat_hidden=4,
                 gat_out_heads=2, gat_out_dim=3)
    spec = build_model_config(cfg, FEAT, LABELS)
    out = []
    for segs in (repack.segments, _parent_segments):
        monkeypatch.setattr(maml, "segments", segs)
        ml = MetaLearner(spec, LABELS, update_lr=0.05, meta_lr=0.01,
                         update_step=2, update_step_test=2, seed=0,
                         agg="sized", task_chunk=1, device="cpu")
        ml.set_features(feats.numpy())
        loss = ml.train_step(TaskBatch(spt, qry))["meta_loss"]
        out.append([loss] + [p.detach().clone() for p in ml.params])
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_launches_stay_put_on_the_cpu(inputs):
    feats, spt, _ = inputs
    spec, params = _params(_cfg("2x8h2"))
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    with metrics.counted() as c:
        out = graphormer.forward([p.requires_grad_() for p in params], sg,
                                 feats, spec)
        torch.autograd.grad(out.sum(), params)
    assert c.of(sa.LAUNCHES) == {"fwd": 0, "bwd": 0, "spd": 0}
    assert c[sa.PAIRS] == 2 * 2 * 8 * 8
    assert module_for(build_model_config(Config(arch="gat"), 5, 2)) is gat
    assert module_for(build_model_config(Config(), 5, 2)) is gcn


def test_bench_graphormer_main_writes_its_json(tmp_path):
    from gmeta_tpu_torch.scripts import bench_graphormer
    out = bench_graphormer.main(["--device", "cpu", "--out",
                                 str(tmp_path / "g.json")])
    (row,) = out["rows"]
    assert row["set"] == "tiny" and row["segments"] == 2 * 2
    assert row["fwd_bound_ms"] > 0 and row["bwd_bound_ms"] > \
        row["fwd_bound_ms"]
