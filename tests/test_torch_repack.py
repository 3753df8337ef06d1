"""The repacked layout (gmeta_tpu_torch/data/repack.py: each task's live
slots in one bin) against the slot layout of data/pack.py, on tiny packed
sets of uneven fill: bins of different fill, an empty bin, tasks of
different live counts (so some carry tail padding), duplicate edges and pad
edges. The GCN on the CSR path (node and link prediction, float32 and
bf16) and the GAT: each live row's layer outputs, the logits, the inner
loop's per-task gradients and a whole train_step's theta; the dense path
bitwise as it was; the tally exactly; the Trainer's record of it. CPU;
imports neither jax nor the JAX package."""

import json

import numpy as np
import pytest
import torch

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data import repack
from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to
from gmeta_tpu_torch.meta.protonet import proto_loss_spt
from gmeta_tpu_torch.models import module_for
from gmeta_tpu_torch.run.train import Trainer
from gmeta_tpu_torch.utils.metrics import counted

torch.set_num_threads(2)

FEAT, ROWS, LABELS = 6, 60, 2
LR, META_LR = 0.05, 1e-3
# bins of different fill, an empty bin (last, or between two live bins),
# a full bin, and tasks whose live counts differ (tail padding in one bin)
SPT_FILL = [[7, 5, 0], [8, 2, 3], [4, 0, 2]]
QRY_FILL = [[6, 6], [3, 0], [8, 5]]
P = 8
CASES = {  # arch, link prediction, compute dtype
    "gcn_node_f32": ("gcn", False, torch.float32),
    "gcn_link_f32": ("gcn", True, torch.float32),
    "gcn_node_bf16": ("gcn", False, torch.bfloat16),
    "gcn_link_bf16": ("gcn", True, torch.bfloat16),
    "gat_node_f32": ("gat", False, torch.float32),
}


def _set(rng, fills, S, E) -> SubgraphSet:
    """Packed sets of T tasks, fills[t][b] live slots in bin b: every live
    node an in-edge from its bin, then random edges within bins, two
    duplicated, sorted by destination; pad edges (src 0, dst B*P-1, mask
    0) fill the edge budget E. Centre k lies in the k-th live bin (round
    robin); the link head's second endpoint in the same bin."""
    fills = np.asarray(fills, np.int32)
    T, B = fills.shape
    node_gid = np.zeros((T, B, P), np.int32)
    node_mask = np.zeros((T, B, P), np.float32)
    src = np.zeros((T, E), np.int32)
    dst = np.full((T, E), B * P - 1, np.int32)
    mask = np.zeros((T, E), np.float32)
    centers = np.zeros((T, S, 2), np.int32)
    for t in range(T):
        edges = []
        live_bins = [b for b in range(B) if fills[t, b]]
        for b in live_bins:
            f = fills[t, b]
            node_gid[t, b, :f] = rng.randint(1, ROWS, f)
            node_mask[t, b, :f] = 1
            edges += [(b * P + rng.randint(f), b * P + i) for i in range(f)]
            edges += [(b * P + rng.randint(f), b * P + rng.randint(f))
                      for _ in range(2 * f)]
        edges += edges[-2:]                 # duplicate edge slots
        edges.sort(key=lambda e: e[1])
        n = len(edges)
        assert n <= E
        src[t, :n], dst[t, :n] = np.array(edges).T
        mask[t, :n] = 1
        for k in range(S):
            b = live_bins[k % len(live_bins)]
            centers[t, k] = b * P + rng.randint(fills[t, b], size=2)
    labels = np.tile(np.arange(S) % LABELS, (T, 1)).astype(np.int32)
    return SubgraphSet(node_gid, node_mask, src, dst, mask, centers, labels,
                       fills)


@pytest.fixture(scope="module")
def data():
    rng = np.random.RandomState(7)
    feats = torch.from_numpy(rng.randn(ROWS, FEAT).astype(np.float32))
    batch = TaskBatch(spt=_set(rng, SPT_FILL, S=4, E=80),
                      qry=_set(rng, QRY_FILL, S=6, E=90))
    return feats, batch


def _spec(arch, link):
    if arch == "gat":
        cfg = Config(arch="gat", gat_heads=2, gat_hidden=4, gat_out_heads=3,
                     gat_out_dim=3)
    else:
        cfg = Config(hidden_dim=8, h=2, link_pred_mode=link)
    return build_model_config(cfg, FEAT, LABELS)


def _params(spec, seed=0):
    """Theta with the published init, its vectors and biases moved off
    zero, so every term of the layers matters."""
    gen = torch.Generator().manual_seed(seed)
    params = list(module_for(spec).init_params(gen, spec))
    return [p + 0.3 * torch.randn(p.shape, generator=gen) if p.dim() == 1
            else p for p in params]


def _live_rows(x, fills):
    """Task t's live rows of x (T, B, P, H) in bin order, slot order."""
    return [torch.cat([x[t, b, :f] for b, f in enumerate(fill)])
            for t, fill in enumerate(np.asarray(fills))]


def _close(got, want, dtype, msg):
    """Within the compute dtype's rounding: float32's, or one bf16 ulp,
    since a product over other rows may round an ulp of float32 apart
    before its cast to bf16."""
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=2 ** -8, atol=1e-5)
    torch.testing.assert_close(got.float(), want.float(), msg=msg, **tol)


def _both(batch):
    """(slot layout, repacked layout) of a host batch on the CPU."""
    dev = batch_to(batch, "cpu")
    live = tuple(repack.live_counts(sg.bin_fill) for sg in batch)
    rows = tuple(repack.bin_rows(n) for n in live)
    return dev, repack.repack_batch(dev, rows, live)


def _learner(spec, dtype, agg="sized"):
    ml = MetaLearner(spec, LABELS, update_lr=LR, meta_lr=META_LR,
                     update_step=2, update_step_test=2, seed=4,
                     compute_dtype=dtype, agg=agg, device="cpu")
    ml.set_params(_params(spec))
    return ml


def _pool(batch):
    """Six tasks: the batch's three, then the same in reverse order."""
    return TaskBatch(*(SubgraphSet(*(np.concatenate([x, x[::-1]])
                                     for x in sg)) for sg in batch))


@pytest.mark.parametrize("case", sorted(CASES))
def test_repacked_sets_give_the_slot_layouts_numbers(data, case):
    arch, link, dtype = CASES[case]
    feats, batch = data
    spec = _spec(arch, link)
    model = module_for(spec)
    slot, packed = _both(batch)

    # the layout: live gids in bin and slot order, then padding
    for sg, rp in zip(slot, packed):
        T, B, _ = sg.node_gid.shape
        M = rp.node_gid.shape[-1]
        live = sg.bin_fill.sum(1)
        assert rp.node_gid.shape == (T, 1, M) and M % repack.ROW_MULTIPLE == 0
        assert M == repack.bin_rows(live.numpy())
        for t in range(T):
            n = int(live[t])
            want = torch.cat([sg.node_gid[t, b, :f]
                              for b, f in enumerate(sg.bin_fill[t])])
            assert torch.equal(rp.node_gid[t, 0, :n], want)
            assert not rp.node_gid[t, 0, n:].any()
            assert torch.equal(rp.node_mask[t, 0],
                               (torch.arange(M) < n).float())
        assert torch.equal(rp.bin_fill[:, 0], live.int())
        assert torch.equal(rp.edge_mask, sg.edge_mask)
        pad = rp.edge_mask == 0
        assert (rp.edge_dst[pad] == M - 1).all() and \
            (rp.edge_src[pad] == 0).all()
        assert (rp.edge_dst.diff(dim=1) >= 0).all()

    # each live row's layer outputs, the logits, the inner gradients
    params = _params(spec)
    for sg, rp in zip(slot, packed):
        outs = []
        for s in (sg, rp):
            col = []
            w = [p.unsqueeze(0).expand((s.node_gid.shape[0],) + p.shape)
                 .clone().requires_grad_() for p in params]
            logits = model.forward(
                w, s, feats, spec, graph=model.precompute(
                    s, dtype, feats=feats, agg="sized"),
                compute_dtype=dtype, agg="sized", collect=col)
            loss = proto_loss_spt(logits, s.labels, LABELS)[0]
            outs.append((col, logits, torch.autograd.grad(loss.sum(), w)))
        (c0, l0, g0), (c1, l1, g1) = outs
        fills = sg.bin_fill.numpy()
        for li, (a, b) in enumerate(zip(c0, c1)):
            for t, (x, y) in enumerate(zip(_live_rows(a, fills),
                                           _live_rows(b, rp.bin_fill))):
                _close(y, x, dtype, f"layer {li + 1} task {t}")
        _close(l1, l0, dtype, "logits")
        for i, (a, b) in enumerate(zip(g0, g1)):
            _close(b, a, dtype, f"inner gradient {i}")

    # a whole train_step: repacked (a host batch) against the slot layout
    # (tensors, which the learner takes as decoded)
    ml, ref = _learner(spec, dtype), _learner(spec, dtype)
    for m in (ml, ref):
        m.set_features(feats.numpy())
    with counted() as c:
        m1 = ml.train_step(batch)
    assert c[repack.TALLY["rows"]] > 0
    m0 = ref.train_step(batch_to(batch, "cpu"))
    _close(m1["meta_loss"], m0["meta_loss"], torch.float32, "meta_loss")
    for i, (a, b) in enumerate(zip(ref.params, ml.params)):
        if i == len(params) - 1:
            # the head bias: its meta-gradient is rounding noise, which Adam
            # normalises (tests/test_torch_meta.py `_assert_params_close`)
            for p in (a, b):
                assert (p - params[i]).abs().max() <= META_LR * 1.001
        else:
            torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-5,
                                       msg=f"theta {i}")


def test_a_repacked_set_repacks_to_itself(data):
    _, batch = data
    _, packed = _both(batch)
    live = tuple(sg.bin_fill[:, 0].numpy() for sg in packed)
    again = repack.repack_batch(
        packed, tuple(sg.node_gid.shape[-1] for sg in packed), live)
    for a, b in zip(again, packed):
        assert a is b


# the repack counts of one step over tasks 0, 2 and 2 of `_pool`
STEP_0_2_2 = {"slots": 120, "rows": 3 * (repack.bin_rows([12, 6])
                                         + repack.bin_rows([12, 13])),
              "live": 12 + 6 + 6 + 12 + 13 + 13}


@pytest.mark.parametrize("arch", ["gcn", "gat"])
def test_tally_counts_slots_rows_and_live_exactly(data, arch):
    feats, batch = data
    spec = _spec(arch, False)
    ml = _learner(spec, torch.float32)
    ml.set_features(feats.numpy())
    T = len(SPT_FILL)
    live = [np.sum(SPT_FILL, axis=1), np.sum(QRY_FILL, axis=1)]
    step = {"slots": T * P * (3 + 2),
            "rows": T * sum(repack.bin_rows(n) for n in live),
            "live": int(sum(n.sum() for n in live))}
    assert step == {"slots": 120, "rows": 3 * (16 + 16), "live": 59}

    def tally(fn):
        with counted() as c:
            fn()
        return c.of(repack.TALLY)
    assert tally(lambda: ml.train_step(batch)) == step
    assert tally(lambda: ml.finetune_batch(batch)) == step
    # a K-step call counts each step's tasks
    ml.set_task_pool_compact(_pool(batch))
    idx = np.array([[0, 1, 2], [5, 4, 3]])
    assert tally(lambda: ml.train_steps_from_compact(idx)) == {
        k: 2 * v for k, v in step.items()}
    assert tally(lambda: ml.train_steps_from_compact([[0, 2, 2]])) == \
        STEP_0_2_2


def test_counted_reads_a_compact_calls_repack_counts_by_name(data):
    """The registry's table holds the repack's counts under their dotted
    names: a compact call's deltas are the tally test's numbers."""
    feats, batch = data
    ml = _learner(_spec("gcn", False), torch.float32)
    ml.set_features(feats.numpy())
    ml.set_task_pool_compact(_pool(batch))
    with counted() as c:
        ml.train_steps_from_compact([[0, 2, 2]])
    assert {k: c[f"repack.{k}"] for k in STEP_0_2_2} == STEP_0_2_2
    assert repack.TALLY == {k: f"repack.{k}" for k in STEP_0_2_2}


@pytest.mark.parametrize("link", [False, True])
def test_dense_path_keeps_the_slot_layout_bitwise(data, link):
    """On the dense path nothing is repacked or counted: the step runs on
    the batch's slot layout, and theta is the same bits as a step on the
    batch as tensors, which no path repacks."""
    feats, batch = data
    spec = _spec("gcn", link)
    ml, ref = (_learner(spec, torch.float32, agg="dense") for _ in range(2))
    for m in (ml, ref):
        m.set_features(feats.numpy())
    decoded, segs = ml._decode(batch, tuple(sg.bin_fill for sg in batch))
    assert segs is None
    for a, b in zip(decoded, batch_to(batch, "cpu")):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    with counted() as c:
        m1 = ml.train_step(batch)
    assert c.of(repack.TALLY) == {"slots": 0, "rows": 0, "live": 0}
    m0 = ref.train_step(batch_to(batch, "cpu"))
    for k in m0:
        assert torch.equal(m1[k], m0[k]), k
    for a, b in zip(ml.params, ref.params):
        assert torch.equal(a, b)


def test_trainer_records_the_row_and_live_shares(tmp_path):
    """Each train_window record's row_share and live_share are the tally's
    counts over its window's steps, on the compact and the host-windowed
    pool alike."""
    store, ds = synthetic_disjoint(nodes_per_graph=300, feat_dim=8,
                                   num_classes=9, batchsz=12,
                                   sample_nodes=64, seed=3)
    pool = ds["train"].stacked_pool()
    live = [repack.live_counts(sg.bin_fill) for sg in pool]
    for mode in ("compact", "host"):
        path = tmp_path / f"{mode}.jsonl"
        cfg = Config(hidden_dim=8, epoch=1, task_num=4, update_step=1,
                     update_step_test=1, agg="sized", device_task_pool=True,
                     train_result_report_steps=2, host_pool_window=2,
                     compact_pool_hbm_gb=0.0 if mode == "host" else 100.0,
                     metrics_path=str(path))
        tr = Trainer(cfg, store, ds, labels_num=3, device="cpu")
        idx = tr._epoch_steps(0)
        tr.fit()
        recs = [json.loads(line) for line in path.read_text().splitlines()]
        wins = [r for r in recs if r["kind"] == "train_window"]
        assert len(wins) == -(-len(idx) // 2) > 1, mode
        windows = (idx[i:i + 2] for i in range(0, len(idx), 2))
        for w, rows in zip(wins, windows):
            slots = sum(sg.node_gid[0].size for sg in pool) * rows.size
            n_rows = sum(4 * repack.bin_rows(n[r]) for n in live
                         for r in rows)
            n_live = sum(int(n[rows].sum()) for n in live)
            assert w["row_share"] == round(n_rows / slots, 4), mode
            assert w["live_share"] == round(n_live / n_rows, 4), mode
            assert w["row_share"] < 1


@pytest.mark.parametrize("live", [[12, 17, 6], [12, 6]])
def test_repack_refuses_counts_it_cannot_hold(data, live):
    """A task of more live slots than M, or counts for other tasks than
    the set's, is refused on the host before anything is moved."""
    _, batch = data
    sg = batch_to(batch, "cpu").spt
    with pytest.raises(ValueError, match="live counts"):
        repack.repack(sg, 16, np.array(live))


def test_windows_keep_their_own_live_counts(data):
    """Two windows put before either runs (double buffering) each run with
    their own steps' live counts, which travel with the device buffer: the
    same bits as putting and running them in turn, though the second
    window's rows (M) differ from the first's."""
    from gmeta_tpu_torch.meta.maml import take_tasks
    feats, batch = data
    pool = _pool(batch)
    first, second = np.array([0, 1, 2]), np.array([2, 2, 2])
    live = repack.live_counts(pool.spt.bin_fill)
    assert repack.bin_rows(live[first]) != repack.bin_rows(live[second])
    spec = _spec("gcn", False)
    bufs = [MetaLearner.encode_window(take_tasks(pool, i), 3)
            for i in (first, second)]
    ms = []
    for overlap in (False, True):
        ml = _learner(spec, torch.float32)
        ml.set_features(feats.numpy())
        if overlap:
            wins = [ml.put_buffer(*b)[0] for b in bufs]
            got = [ml.train_steps_from_window(w, 3) for w in wins]
        else:
            got = [ml.train_steps_from_window(ml.put_buffer(*b)[0], 3)
                   for b in bufs]
        ms.append((got, [p.clone() for p in ml.params]))
    (g0, p0), (g1, p1) = ms
    for a, b in zip(g0, g1):
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(p0, p1):
        assert torch.equal(a, b)


def _segment_of(graph, rows):
    """Each row's segment index under the graph's segment table."""
    return torch.searchsorted(graph.seg.long(), rows, right=True)


def _check_segments(graph, N, bound):
    """The table runs from 0 to N without going back, no segment holds
    more than `bound` rows, and every real edge's source lies in its
    destination's segment."""
    seg = graph.seg.long()
    assert int(seg[0]) == 0 and int(seg[-1]) == N
    assert bool((seg[1:] >= seg[:-1]).all())
    assert graph.seg_rows == bound >= int((seg[1:] - seg[:-1]).max())
    row_ptr, col = graph.sized.csr("fwd")
    dst = torch.repeat_interleave((row_ptr[1:] - row_ptr[:-1]).long())
    src = col[:dst.numel()].long()
    assert torch.equal(_segment_of(graph, dst), _segment_of(graph, src))
    return dst.numel()


def _packer_batch():
    """A step's batch as the packer fills it (data/pack.py's first-fit
    decreasing over extracted subgraphs): bins of uneven fill."""
    from gmeta_tpu_torch.meta.maml import take_tasks
    _, ds = synthetic_disjoint(nodes_per_graph=300, feat_dim=8,
                               num_classes=9, batchsz=12, sample_nodes=64,
                               seed=3)
    return take_tasks(ds["train"].stacked_pool(), np.arange(4))


@pytest.mark.parametrize("fills", ["fixture", "packer"])
def test_segments_cover_every_row_and_hold_every_edge(data, fills):
    """The attention's segments (ops/gat_attention.py) of a GAT's sets as
    the learner builds them: in the slot layout each bin of P, in the
    repacked one each original bin's live rows and the tails' padding in
    pieces (data/repack.py `segments`). Either way they cover every row,
    no real edge leaves its segment, and the host's bound is P or the
    largest fill."""
    from gmeta_tpu_torch.models import gat
    batch = data[1] if fills == "fixture" else _packer_batch()
    ml = _learner(_spec("gat", False), torch.float32)
    host = tuple(sg.bin_fill for sg in batch)
    repacked, segs = ml._decode(batch, host)
    assert segs is not None
    for sg, rp, seg, f in zip(batch_to(batch, "cpu"), repacked, segs, host):
        T, B, Pb = sg.node_gid.shape
        slot = gat.precompute(sg).attn
        assert _check_segments(slot, T * B * Pb, Pb) > 0
        M = rp.node_gid.shape[-1]
        graph = gat.precompute(rp, segments=seg).attn
        assert _check_segments(graph, T * M, int(np.max(f))) > 0
        # each original bin's live rows are one segment
        starts = set(graph.seg.tolist())
        for t in range(T):
            first = t * M + np.concatenate([[0], np.cumsum(f[t])[:-1]])
            assert set(first.tolist()) <= starts


def test_route_follows_the_bin_size_and_the_largest_fill(monkeypatch):
    """The host picks the staged kernels where its bound on a segment's
    rows (P in the slot layout, the largest fill in the repacked one) fits
    their shared memory, and the walk kernels otherwise, or where a
    repacked graph comes without its segments; each launch is counted
    under LAUNCHES, a staged one under STAGED too."""
    from gmeta_tpu_torch.ops import gat_attention as ga
    limit = ga.STAGE_ROWS

    def graph(fills, P, repacked):
        fills = np.asarray(fills, np.int32)
        T, B = fills.shape
        dst = torch.tensor([[b * P for b in range(B)]] * T)
        mask = torch.ones(dst.shape)
        if not repacked:
            return ga.attn_graph(dst, dst, mask, B, P)
        M = repack.bin_rows(repack.live_counts(fills))
        first = torch.from_numpy(np.concatenate(
            [np.zeros((T, 1), np.int64), np.cumsum(fills, 1)[:, :-1]], 1))
        seg = repack.segments(torch.from_numpy(fills), M, fills)
        return ga.attn_graph(first, first, mask, 1, M, seg)

    cases = [  # fills, P, repacked -> route
        ([[5, 7]], 8, False, "staged"),
        ([[5, 7]], limit, False, "staged"),
        ([[5, 7]], limit + 8, False, "walk"),
        ([[1000, 1000], [900, 0]], 1024, True, "staged"),   # M 2000 > limit
        ([[limit, 3]], limit, True, "staged"),
        ([[limit + 1, 3]], limit + 8, True, "walk"),
    ]
    calls = []
    monkeypatch.setattr(ga, "_call",
                        lambda how, d, *rest: calls.append((how, d)) or 0)
    K, F = 1, 4
    for fills, P, repacked, want in cases:
        g = graph(fills, P, repacked)
        assert ga.route(g) == want, (fills, P, repacked)
        N = g.sized.row_ptr.numel() - 1
        zst = torch.zeros(N, K * F + 2 * K)
        calls.clear()
        with counted() as c:
            o, lse = ga._launch_fwd(g, zst, K, F)
            ga._launch_bwd(g, zst, o, lse, torch.zeros(N, K * F), K, F)
        assert calls == [(want, "fwd"), (want, "bwd")]
        assert c.of(ga.LAUNCHES) == {"fwd": 1, "bwd": 3}
        staged = want == "staged"
        assert c.of(ga.STAGED) == {"fwd": int(staged), "bwd": 3 * staged}
    # a repacked graph without its segments: one bin of M rows
    rp = graph([[1000, 1000]], 1024, True)
    assert ga.route(ga.attn_graph(*(rp.sized.col[None],) * 2,
                                  torch.ones(1, 2), 1, 2000)) == "walk"
    assert ga.route(rp._replace(seg=None, seg_rows=0)) == "walk"


@pytest.mark.parametrize("segments,K", [(256, 4), (96, 4), (96, 6), (1, 1),
                                        (10 ** 5, 6)])
def test_shares_fill_the_card(segments, K):
    """A segment and head is split among just enough blocks (at most 8)
    for the grid to hold _BLOCKS_PER_SM blocks an SM."""
    from gmeta_tpu_torch.ops import gat_attention as ga
    n = ga.shares(segments, K, 132)
    assert 1 <= n <= 8
    want = ga._BLOCKS_PER_SM * 132
    assert segments * K * n >= want or n == 8
    assert n == 1 or segments * K * (n - 1) < want
