"""The port's GAT (gmeta_tpu_torch/models/gat.py, ops/gat_attention.py)
against the plain reference of tests/gat_reference.py on seeded random
weights, over tiny packed sets with duplicate edges, an isolated live node,
pad slots, two tasks and a 3-wide ragged head: a layer's output and the
logits, the meta-step, the op's backward by gradcheck, the configuration's
refusals, the Trainer and its CLI, and the GCN's bits unchanged. CPU;
imports neither jax nor the JAX package."""

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gat_reference import Reference
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.data.pipeline import SplitGeometry, agg_for
from gmeta_tpu_torch.data.synthetic import (synthetic_disjoint,
                                            synthetic_link_pred)
from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to
from gmeta_tpu_torch.models import gat, gcn, module_for
from gmeta_tpu_torch.ops import gat_attention
from gmeta_tpu_torch.ops.gat_attention import attend, attn_graph
from gmeta_tpu_torch.ops.sized_spmm import sized_graph
from gmeta_tpu_torch.run import train as train_mod
from gmeta_tpu_torch.utils import metrics

torch.set_num_threads(2)

FEAT, ROWS, LABELS = 5, 40, 2
# (heads, width) of layers 1-2, (heads, width) of layer 3: widths of 3
# take the kernels' ragged path on the card
WIDTHS = {"2x4_3x3": (2, 4, 3, 3), "3x8_2x3": (3, 8, 2, 3)}
# float32 against the reference's dense per-bin sums: the same terms added
# in another order round apart by a few ulps
RTOL, ATOL = 1e-5, 1e-6


def _cfg(widths, **kw):
    K, F, K3, F3 = WIDTHS[widths]
    return Config(arch="gat", gat_heads=K, gat_hidden=F, gat_out_heads=K3,
                  gat_out_dim=F3, **kw)


def _ref_cfg(cfg: Config, update_step=2) -> dict:
    return {"feat_dim": FEAT, "gat_heads": cfg.gat_heads,
            "gat_hidden": cfg.gat_hidden, "gat_out_heads": cfg.gat_out_heads,
            "gat_out_dim": cfg.gat_out_dim, "labels_num": LABELS,
            "update_lr": 0.05, "update_step": update_step, "meta_lr": 0.01}


def _tiny_set(rng, T=2, B=2, P=8, fill=(6, 5), E=40, S=4) -> SubgraphSet:
    """T tasks' packed sets: B bins of P slots, `fill` live slots a bin,
    random real edges within bins (slot 0 of bin 0 has none: an isolated
    live node), two duplicated, sorted by destination, then pad edges
    (src 0, dst B*P-1, mask 0) as the packer leaves them."""
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
            lo = 1 if b == 0 else 0        # slot 0 of bin 0: isolated
            for _ in range(3 * f):
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
        centers[t, 0] = 0                  # the isolated node is a centre
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
    """Theta with the published init, its attention vectors and biases
    then moved off zero, so every term of the layers matters."""
    spec = build_model_config(cfg, FEAT, LABELS)
    gen = torch.Generator().manual_seed(seed)
    params = list(gat.init_params(gen, spec))
    for i, p in enumerate(params):
        if p.dim() == 1 or i % 4 in (1, 2):
            params[i] = p + 0.3 * torch.randn(p.shape, generator=gen)
    return spec, params


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_layers_and_logits_match_the_reference(inputs, widths):
    feats, spt, _ = inputs
    cfg = _cfg(widths)
    spec, params = _params(cfg)
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    collect = []
    logits = gat.forward(params, sg, feats, spec, collect=collect)
    ref = Reference(_ref_cfg(cfg))
    T, B, P = spt.node_gid.shape
    for t in range(T):
        task = _task(spt, t)
        g = ref.graph(task, feats.device)
        for li, want in enumerate(ref.embed(params, task, feats, g)):
            got = collect[li][t].reshape(B * P, -1)
            torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL,
                                       msg=f"layer {li + 1}, task {t}")
        torch.testing.assert_close(logits[t],
                                   ref.logits(params, task, feats, g),
                                   rtol=RTOL, atol=ATOL)


def test_the_isolated_node_and_pad_slots_take_their_self_term(inputs):
    """A row with no in-edge (an isolated live node, a pad slot) is its own
    z: one term of weight 1."""
    feats, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    T, B, P = spt.node_gid.shape
    graph = attn_graph(sg.edge_src, sg.edge_dst, sg.edge_mask, B, P)
    K, F = 2, 3
    zst = torch.randn(T * B * P, K * F + 2 * K)
    o = attend(graph, zst, K, F)
    lonely = torch.nonzero(graph.sized.degrees() == 0).flatten()
    assert 0 in lonely.tolist() and (T * B * P - 1) in lonely.tolist()
    torch.testing.assert_close(o[lonely], zst[lonely, :K * F], rtol=0,
                               atol=0)


def test_duplicates_count_once_each():
    """Two slots of one edge weigh as two terms: the softmax over (self,
    j, j) gives j twice the weight of one slot."""
    src, dst = torch.tensor([[1, 1]]), torch.tensor([[0, 0]])
    graph = attn_graph(src, dst, torch.ones(1, 2), 1, 2)
    K, F = 1, 2
    zst = torch.tensor([[1.0, 0.0, 0.3, -0.2], [0.0, 1.0, 0.5, 0.1]])
    w = torch.softmax(torch.tensor(
        [max(-0.2 + 0.3, 0.2 * (-0.2 + 0.3)), -0.2 + 0.5, -0.2 + 0.5]), 0)
    want = torch.tensor([w[0], w[1] + w[2]])
    torch.testing.assert_close(attend(graph, zst, K, F)[0], want)


def test_transposed_positions_name_the_same_edges(inputs):
    _, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    T, B, P = spt.node_gid.shape
    g = attn_graph(sg.edge_src, sg.edge_dst, sg.edge_mask, B, P)
    s = g.sized
    nnz = int(s.row_ptr[-1])
    rows = torch.repeat_interleave((s.row_ptr[1:] - s.row_ptr[:-1]).long())
    rows_t = torch.repeat_interleave(
        (s.row_ptr_t[1:] - s.row_ptr_t[:-1]).long())
    pos = g.pos_t[:nnz].long()
    assert sorted(pos.tolist()) == list(range(nnz))
    assert torch.equal(s.col_t[pos].long(), rows)     # destinations
    assert torch.equal(rows_t[pos], s.col[:nnz].long())   # sources
    plain = sized_graph(sg.edge_src, sg.edge_dst, sg.edge_mask, B, P)
    assert all(torch.equal(a, b) for a, b in zip(s, plain))


@pytest.mark.parametrize("K,F", [(2, 3), (3, 4)])
def test_gradcheck_of_the_plain_path_in_float64(inputs, K, F):
    _, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    T, B, P = spt.node_gid.shape
    graph = attn_graph(sg.edge_src, sg.edge_dst, sg.edge_mask, B, P)
    zst = torch.randn(T * B * P, K * F + 2 * K, dtype=torch.float64,
                      generator=torch.Generator().manual_seed(K),
                      requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: attend(graph, x, K, F),
                                    (zst,))


def test_the_backward_is_first_order_only(inputs):
    _, spt, _ = inputs
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    graph = attn_graph(sg.edge_src, sg.edge_dst, sg.edge_mask, 2, 8)
    zst = torch.randn(32, 10, requires_grad=True)
    out = attend(graph, zst, 2, 3).sum()
    with pytest.raises(NotImplementedError, match="first-order"):
        torch.autograd.grad(out, zst, create_graph=True)


@pytest.mark.parametrize("widths", sorted(WIDTHS))
def test_train_step_matches_first_order_protomaml(inputs, widths):
    """Two MetaLearner.train_step calls against the reference's two
    meta-steps from the same theta: the first meta-loss, the first
    meta-gradient as Adam holds it, theta after both."""
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
    np.testing.assert_allclose([loss1, loss2], ref["losses"], rtol=RTOL)
    for i, (got, want) in enumerate(zip(grad1, ref["grad1"])):
        # gradients: float32 sums over tasks and terms in another order
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6,
                                   msg=f"grad of leaf {i}")
    # Adam moves a parameter whose gradient is rounding noise by the sign
    # of that noise: the head's bias (the prototype loss does not see a
    # shift of every centre alike) and a_dst of a head whose scores all lie
    # on one side of LeakyReLU's kink (t_i then cancels in its softmax).
    # Such entries, below 1e-5 of the largest first gradient, are left out.
    floor = 1e-5 * max(float(g.abs().max()) for g in ref["grad1"])
    for i, (got, want) in enumerate(zip(ml.params, ref["theta"])):
        real = ref["grad1"][i].abs() > floor
        torch.testing.assert_close(got.detach()[real], want[real], rtol=1e-5,
                                   atol=1e-6, msg=f"theta leaf {i}")
    assert sum(int((g.abs() > floor).sum()) for g in ref["grad1"]) > \
        0.9 * sum(g.numel() for g in ref["grad1"])


def test_build_model_config_gives_the_published_layers():
    cfg = Config(arch="gat").validate()
    assert (cfg.gat_heads, cfg.gat_hidden, cfg.gat_out_heads,
            cfg.gat_out_dim) == (4, 256, 6, 121)
    spec = build_model_config(cfg, 50, 2)
    assert spec == (("GATConv", (50, 4, 256, True, False)),
                    ("GATConv", (1024, 4, 256, True, True)),
                    ("GATConv", (1024, 6, 121, False, False)),
                    ("Linear", (121, 2)))
    assert module_for(spec) is gat
    assert module_for(build_model_config(Config(), 50, 2)) is gcn
    params = gat.init_params(torch.Generator().manual_seed(0), spec)
    assert [tuple(p.shape) for p in params] == [
        (50, 1024), (4, 256), (4, 256), (1024,),
        (1024, 1024), (4, 256), (4, 256), (1024,),
        (1024, 726), (6, 121), (6, 121), (121,), (2, 121), (2,)]
    assert sum(p.numel() for p in params) == 1_851_161
    a = params[1].abs().max()
    assert a <= (6 / (4 + 256)) ** 0.5 and a > 0.9 * (6 / (4 + 256)) ** 0.5


@pytest.mark.parametrize("field,value,what", [
    ("agg", "dense", "agg='dense'"),
    ("dtype", "bfloat16", "dtype 'bfloat16'"),
    ("link_pred_mode", True, "link prediction"),
    ("first_order", False, "second-order"),
    ("mesh_edges", 2, "edge engine"),
    ("mesh_tasks", 2, "task-DP"),
])
def test_validate_refuses_what_gat_lacks(field, value, what):
    kw = {"task_setup": "Shared"} if field == "link_pred_mode" else {}
    if field.startswith("mesh"):
        with pytest.raises(ValueError, match=what):
            Config(arch="gat", **kw).validate(**{field: value})
        Config(**kw).validate(**{field: value})      # the GCN takes it
        return
    with pytest.raises(ValueError, match=f"arch='gat' has no.*{what}"):
        Config(arch="gat", **{field: value}, **kw).validate()
    Config(**{field: value}, **kw).validate()


def test_any_other_model_name_is_the_gcn():
    """A benchmark configuration's `model` names its file under
    benchmark/models/ (a variant of the GCN's counts, say), not the
    program's architecture: that is `arch`, G-Meta's GCN unless set, and
    validate() refuses any name but 'gcn' and 'gat', so that a typo trains
    nothing under a wrong name."""
    assert "model" not in {f.name for f in dataclasses.fields(Config)}
    spec = build_model_config(Config().validate(), 5, 2)
    assert spec == build_model_config(Config(arch="gcn").validate(), 5, 2)
    assert module_for(spec) is gcn
    for name in ("gcn_x2", "GAT", "gat2", ""):
        with pytest.raises(ValueError, match="no architecture of the port"):
            Config(arch=name).validate()


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_auto_is_the_csr_path_for_a_gat_on_every_device(device):
    geo = SplitGeometry(1024, 6, 51200, 1024, 16, 141312, 135909.0, 0.5726)
    spec = build_model_config(Config(arch="gat"), 50, 2)
    assert agg_for(geo, torch.device(device), spec) == "sized"
    dense = SplitGeometry(64, 2, 64 * 64 * 2, 64, 2, 64 * 64 * 2,
                          4.0 * 64 * 64 * 2 * 0.99, 0.99)
    assert agg_for(dense, torch.device(device), spec) == "sized"


def test_set_params_refuses_another_models_theta():
    gcn_spec = build_model_config(Config(hidden_dim=8), FEAT, LABELS)
    ml = MetaLearner(gcn_spec, LABELS, update_lr=0.05, meta_lr=0.01,
                     update_step=1, update_step_test=1, device="cpu")
    spec, theta = _params(_cfg("2x4_3x3"))
    with pytest.raises(ValueError, match="theta has leaves"):
        ml.set_params(theta)
    with pytest.raises(ValueError, match="theta has leaves"):
        ml.set_params([p[:1] for p in ml.params])


def test_attn_spans_wrap_every_call_forward_and_backward(inputs):
    """Under a profiler each attention call and each of its backwards is
    an `attn` span: 3 layers x (support forwards and backwards, query
    forwards and the meta-loss's backward) of one meta-step."""
    feats, spt, qry = inputs
    spec, theta0 = _params(_cfg("2x4_3x3"))
    ml = MetaLearner(spec, LABELS, update_lr=0.05, meta_lr=0.01,
                     update_step=2, update_step_test=2, seed=0, agg="sized",
                     device="cpu")
    ml.set_params(theta0)
    ml.set_features(feats.numpy())
    batch = TaskBatch(spt, qry)
    want = ml.train_step(batch)["meta_loss"]
    ml.set_params(theta0)
    metrics.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        got = ml.train_step(batch)["meta_loss"]
    window = metrics.spans()
    assert torch.equal(got, want)
    attn = [s for s in window if s.name == "attn"]
    # support: 1 curve + 2 inner forwards, 2 inner backwards + the
    # meta-gradient's; query: 1 + 2 curve/meta forwards, 1 backward
    assert len(attn) == 3 * ((3 + 3) + (3 + 1))
    assert all(s.parent < 0 or window[s.parent].name != "attn"
               for s in attn)


def _fit_args(pool: bool):
    return ["--arch", "gat", "--gat_heads", "2", "--gat_hidden", "4",
            "--gat_out_heads", "2", "--gat_out_dim", "3", "--epoch", "2",
            "--task_num", "4", "--update_step", "2", "--update_step_test",
            "2", "--update_lr", "0.05", "--n_way", "3", "--k_spt", "3",
            "--k_qry", "4", "--train_result_report_steps", "1",
            "--device_task_pool", str(pool), "--device", "cpu"]


@pytest.mark.parametrize("pool", [False, True])
def test_cli_trains_a_gat_through_the_trainer(monkeypatch, pool):
    """run/train.py's main builds a GAT from --arch gat alone and fits it
    for two epochs through the Trainer (streamed, or from the compact
    resident pool), `auto` resolving to the CSR path."""
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
    assert tr.cfg.arch == "gat" and tr.agg == "sized"
    assert tr.spec[0][0] == "GATConv" and len(tr.learner.params) == 14
    assert res.epochs_run == 2 and res.global_step == 4
    assert np.isfinite(res.test_acc_final)


def test_cli_refuses_a_gat_with_task_dp():
    with pytest.raises(ValueError, match="task-DP"):
        train_mod.main(_fit_args(False) + ["--mesh_tasks", "2"])


# -- the GCN keeps its bits --------------------------------------------------

def _parent_forward(params, sg, feats, layer_spec: Sequence[Tuple[str, tuple]],
                    graph=None, compute_dtype=torch.float32, agg="dense"):
    """models/gcn.py `forward` as it was before the GAT: the same calls, in
    the same order."""
    link_pred = layer_spec[-1][0] == "LinkPred"
    T, B, P = sg.node_gid.shape
    if graph is None:
        graph = gcn.precompute(sg, compute_dtype, agg=agg)
    norm = graph.norm
    if agg == "sized":
        def _aggregate(h_):
            return gcn.aggregate_sized(graph.sized, h_)
    else:
        def _aggregate(h_):
            return gcn.aggregate_dense(graph.A, h_)
    h = graph.h0 if graph.h0 is not None else gcn.gather_features(
        sg, feats, compute_dtype)
    h = h * norm
    idx = 0
    gcn_layers = [d for n, d in layer_spec if n == "GraphConv"]
    for li, (fan_in, fan_out) in enumerate(gcn_layers):
        last = li == len(gcn_layers) - 1
        w = params[idx].to(compute_dtype)
        b = params[idx + 1].to(compute_dtype)
        idx += 2
        if fan_in > fan_out:
            h = gcn._matmul(h.reshape(T, B * P, fan_in), w, compute_dtype)
            h = _aggregate(h.reshape(T * B, P, fan_out)).to(compute_dtype)
        else:
            h = _aggregate(h.reshape(T * B, P, fan_in)).to(compute_dtype)
            h = gcn._matmul(h.reshape(T, B * P, fan_in), w, compute_dtype)
        h, _ = gcn.epilogue.graphconv_epilogue(
            h.reshape(T, B, P, fan_out), norm, gcn._bias(b, 4),
            scale_out=not last, keep_y=False)
        if last:
            h = h.reshape(T, B * P, fan_out)
            centers = sg.centers.long()

            def take(col):
                return torch.gather(
                    h, 1, centers[..., col:col + 1].expand(-1, -1, fan_out))
            h = torch.cat([take(0), take(1)], dim=-1) if link_pred \
                else take(0)
    w, b = params[idx], params[idx + 1]
    logits = torch.matmul(h.float(),
                          w.to(compute_dtype).float().transpose(-1, -2))
    return logits + gcn._bias(b.float(), 3)


@pytest.mark.parametrize("link", [False, True])
@pytest.mark.parametrize("agg", ["dense", "sized"])
def test_gcn_forward_keeps_its_bits(agg, link):
    """The GCN's logits and gradients on a fixed input are the parent's
    expression's, bit for bit, now that the readout and head are shared
    with the GAT."""
    if link:
        store, ds = synthetic_link_pred(num_graphs=4, nodes_per_graph=120,
                                        feat_dim=6, k_spt=3, k_qry=3,
                                        batchsz=6, sample_nodes=40, seed=1)
        cfg = Config(task_setup="Shared", link_pred_mode=True, n_way=2,
                     hidden_dim=4)
    else:
        store, ds = synthetic_disjoint(
            num_graphs=1, nodes_per_graph=200, avg_degree=6, feat_dim=6,
            num_classes=9, n_way=3, k_spt=2, k_qry=3, batchsz=6, h=2,
            sample_nodes=40, seed=2)
        cfg = Config(hidden_dim=4)
    spec = build_model_config(cfg, store.feat_dim, 2 if link else 3)
    gen = torch.Generator().manual_seed(4)
    params = [(p + 0.1 * torch.randn(p.shape, generator=gen))
              .requires_grad_() for p in gcn.init_params(gen, spec)]
    sg = batch_to(next(ds["train"].batches(3, shuffle=False)), "cpu").spt
    feats = torch.as_tensor(store.features)
    got = gcn.forward(params, sg, feats, spec, agg=agg)
    want = _parent_forward(params, sg, feats, spec, agg=agg)
    assert torch.equal(got, want)
    g_got = torch.autograd.grad(got.square().sum(), params)
    g_want = torch.autograd.grad(want.square().sum(), params)
    assert all(torch.equal(a, b) for a, b in zip(g_got, g_want))


def test_launches_stay_put_on_the_cpu(inputs):
    feats, spt, _ = inputs
    spec, params = _params(_cfg("2x4_3x3"))
    sg = batch_to(TaskBatch(spt, spt), "cpu").spt
    before = dict(gat_attention.launches)
    out = gat.forward([p.requires_grad_() for p in params], sg, feats, spec)
    torch.autograd.grad(out.sum(), params)
    assert gat_attention.launches == before


def test_bench_gat_main_writes_its_json(tmp_path):
    """scripts/bench_gat.py on the CPU: the plain versions at its tiny
    shape, each row with both bounds, and the shape it drew holds the
    edges it was asked for."""
    import json

    from gmeta_tpu_torch.scripts import bench_gat
    out = tmp_path / "gat.json"
    res = bench_gat.main(["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text())["rows"] == res["rows"]
    assert [(r["K"], r["F"]) for r in res["rows"]] == [(2, 4), (3, 3)]
    for r in res["rows"]:
        assert r["fwd_bound_ms"] > 0 and r["bwd_bound_ms"] > 0
        assert "fwd_ms" not in r and r["fwd_plain_ms"] > 0
    T, B, P, live, edges = bench_gat.TINY["tiny"]
    g = bench_gat.packed_graph(T, B, P, live, edges, torch.device("cpu"))
    deg = g.sized.degrees().view(T, B, P)
    assert int(deg.sum()) == T * edges
    assert bool((deg[..., :live] > 0).all()) and int(deg[..., live:].sum()) == 0
