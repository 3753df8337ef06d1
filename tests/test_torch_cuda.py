"""The CUDA kernels of gmeta_tpu_torch against their plain versions (packed
sets, and the rectangular entry point `csr_gather`: its full-graph body
over column slabs, split rows and the combine kernel), the pool modes' device
decode, pinned window copies and fits, the device extractor, a remat train
step, the collectives on NCCL and gloo at world size 1, and the launch
model's refusal of NCCL ranks that share a card.
Marked `cuda`: they skip where there is no CUDA device (the kernel has no
CPU mode; the CPU tests hold the plain version against the JAX package).
This file imports neither jax nor the JAX package, so it also runs where
those are absent:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data.device_extract import DeviceExtractor
from gmeta_tpu_torch.data.graph import synthetic_store
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner, take_tasks
from gmeta_tpu_torch.ops import sized_spmm
from gmeta_tpu_torch.ops.spmm import densify
from gmeta_tpu_torch.run.train import Trainer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sized_spmm kernel runs only "
                    "on CUDA")
    return torch.device("cuda")


def _packed(P, sizes, H, dtype, device, seed=0):
    """One packed set: edges inside each bin's live corner at 5% density,
    a fifth of them duplicated, pad edges at the end. In the fullest bin
    row 1 has 40 in-edges (more than a warp's lanes), row 2 has 3000, and
    row 3 has 3000 out-edges, which the transpose gathers. Returns the
    graph, x (S, P, H) and the dense adjacency (S, P, P) float32. x holds
    small integers, so every partial sum is exact in float32 (and the
    result in bf16 rounds the same exact sum): any summation order gives
    the same bits, and the comparisons below are exact."""
    rng = np.random.RandomState(seed)
    S = len(sizes)
    src, dst = [], []
    for b, n in enumerate(sizes):
        d, s = np.nonzero(rng.rand(n, n) < 0.05)
        reps = 1 + (rng.rand(d.size) < 0.2)
        dst.append(b * P + np.repeat(d, reps))
        src.append(b * P + np.repeat(s, reps))
    full = int(np.argmax(sizes))
    base, n = full * P, sizes[full]
    for row, count in ((1, 40), (2, 3000)):
        dst.append(np.full(count, base + row))
        src.append(base + rng.randint(0, n, count))
    dst.append(base + rng.randint(0, n, 3000))
    src.append(np.full(3000, base + 3))
    src, dst = np.concatenate(src), np.concatenate(dst)
    order = np.argsort(dst, kind="stable")
    n_pad = 16
    src = np.concatenate([src[order], np.zeros(n_pad, np.int64)])
    dst = np.concatenate([dst[order], np.full(n_pad, S * P - 1)])
    mask = np.concatenate([np.ones(order.size), np.zeros(n_pad)])
    e = [torch.from_numpy(a).to(device) for a in (src, dst, mask)]
    graph = sized_spmm.sized_graph(e[0], e[1], e[2].float(), S, P)
    A = densify(e[0], e[1], e[2].float(), S, P)
    x = torch.from_numpy(rng.randint(-8, 9, (S, P, H)).astype(np.float32))
    return graph, x.to(device, dtype), A


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 5, 50, 128, 256])
def test_kernels_match_plain(cuda, H, dtype):
    sizes = [0, 1, 127, 129, 512]
    graph, x, A = _packed(512, sizes, H, dtype, cuda, seed=H)
    assert int(graph.degrees().max()) >= 3000
    for direction, At in (("fwd", A), ("bwd", A.transpose(1, 2))):
        before = sized_spmm.launches[direction]
        got = sized_spmm.launch(direction, graph, x)
        torch.cuda.synchronize()
        assert sized_spmm.launches[direction] == before + 1
        assert got.dtype == dtype and got.shape == x.shape
        want = sized_spmm.sized_plain(*graph.csr(direction), x)
        assert torch.equal(got, want)
        for s, n in enumerate(sizes):
            assert not got[s, n:].any()            # dead rows are zero
        if dtype == torch.float32:                 # the function itself
            assert torch.equal(got, torch.bmm(At, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T, H", [(1, 5), (3, 128), (32, 8)])
def test_shared_call_matches_plain_and_separate_launches(cuda, T, H, dtype):
    """aggregate_sized_shared: one forward launch at width T * H for T
    tasks over one graph, equal to sized_plain at that width and to T
    launches at width H (exact: integer inputs), and its gradient (one
    transposed launch) to the T transposed launches'."""
    sizes = [0, 1, 127, 129, 512]
    graph, x, _ = _packed(512, sizes, T * H, dtype, cuda, seed=T)
    h = x.view(len(sizes), 512, T, H).permute(2, 0, 1, 3).contiguous()
    h.requires_grad_(True)
    before = dict(sized_spmm.launches)
    got = sized_spmm.aggregate_sized_shared(graph, h)
    torch.cuda.synchronize()
    assert sized_spmm.launches["fwd"] == before["fwd"] + 1
    assert got.shape == h.shape and got.dtype == dtype
    plain = sized_spmm.sized_plain(*graph.csr("fwd"),
                                   h.detach().permute(1, 2, 0, 3)
                                   .reshape(len(sizes), 512, T * H))
    assert torch.equal(got.permute(1, 2, 0, 3).reshape(plain.shape), plain)
    for t in range(T):
        assert torch.equal(got[t], sized_spmm.launch("fwd", graph,
                                                     h[t].detach()))
    w = torch.from_numpy(np.random.RandomState(T).randint(
        -4, 5, tuple(h.shape)).astype(np.float32)).to(cuda, dtype)
    before = dict(sized_spmm.launches)
    (g,) = torch.autograd.grad((got * w).float().sum(), h)
    assert sized_spmm.launches["bwd"] == before["bwd"] + 1
    for t in range(T):
        assert torch.equal(g[t], sized_spmm.launch("bwd", graph, w[t]))


def test_misaligned_input_matches_plain(cuda):
    """x at a 4-byte offset cannot take 16-byte loads: the scalar path."""
    graph, x, _ = _packed(256, [256, 100], 128, torch.float32, cuda)
    flat = torch.empty(x.numel() + 1, device=cuda)
    x_off = flat[1:].view_as(x)
    x_off.copy_(x)
    assert x_off.data_ptr() % 16 != 0 and x_off.is_contiguous()
    for direction in ("fwd", "bwd"):
        assert torch.equal(sized_spmm.launch(direction, graph, x_off),
                           sized_spmm.sized_plain(*graph.csr(direction), x))


def test_double_backward_matches_plain(cuda):
    graph, h, _ = _packed(256, [256, 100, 0], 16, torch.float32, cuda)
    h = h / 64                 # keeps the three inner steps from diverging

    def plain(g, x):
        return sized_spmm.sized_plain(*g.csr("fwd"), x)

    def meta_grad(agg):
        w0 = torch.tensor(1.0, device=cuda, requires_grad=True)
        w = w0
        for _ in range(3):
            inner = agg(graph, h * w).pow(2).mean()
            g, = torch.autograd.grad(inner, w, create_graph=True)
            w = w - 0.1 * g
        return torch.autograd.grad(agg(graph, h * w).sum(), w0)[0]

    before = dict(sized_spmm.launches)
    got = meta_grad(sized_spmm.aggregate_sized)
    assert all(sized_spmm.launches[k] > before[k] for k in before)
    want = meta_grad(plain)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_wrapper_rejects_bad_inputs(cuda):
    graph, h, _ = _packed(128, [128, 64], 8, torch.float32, cuda)
    with pytest.raises(TypeError):
        sized_spmm.launch("fwd", graph, h.half())
    with pytest.raises(TypeError):
        sized_spmm.launch("fwd", graph._replace(col=graph.col.long()), h)
    with pytest.raises(ValueError):
        sized_spmm.launch("fwd", graph, h.transpose(1, 2).contiguous()
                          .transpose(1, 2))
    with pytest.raises(ValueError):
        sized_spmm.launch("fwd", graph, h[:1])
    with pytest.raises(ValueError):
        sized_spmm.launch("fwd", graph, h.cpu())


# ---- pool and window modes on the card -------------------------------------

def _tiny():
    return synthetic_disjoint(num_graphs=1, nodes_per_graph=150,
                              avg_degree=5, feat_dim=8, num_classes=9,
                              n_way=3, k_spt=3, k_qry=4, batchsz=12, h=2,
                              sample_nodes=60, seed=3)


def _learner(store, device):
    ml = MetaLearner(build_model_config(Config(hidden_dim=16),
                                        store.feat_dim, 3), 3,
                     update_lr=0.05, meta_lr=1e-3, update_step=2,
                     update_step_test=2, seed=5, agg="sized", device=device)
    ml.set_features(store.features)
    return ml


def test_device_decode_equals_cpu_decode(cuda):
    """A pinned window buffer copied on the copy stream decodes on the card
    to what the CPU decodes."""
    store, ds = _tiny()
    chunk = take_tasks(ds["train"].stacked_pool(), np.arange(8))
    buf, codec = MetaLearner.encode_window(chunk, 4)
    cpu, gpu = _learner(store, "cpu"), _learner(store, cuda)
    want = cpu._decode_window(cpu.put_buffer(buf, codec)[0])
    dev, copied = gpu.put_buffer(torch.from_numpy(buf).pin_memory(), codec)
    assert copied is not None and dev.is_cuda
    got = gpu._decode_window(dev)
    torch.cuda.synchronize()
    assert copied.query()
    for sg, wsg in zip(got, want):
        for a, b in zip(sg, wsg):
            assert a.is_cuda and a.dtype == b.dtype
            assert torch.equal(a.cpu(), b)


def test_compact_steps_equal_streaming_steps(cuda):
    store, ds = _tiny()
    pool = ds["train"].stacked_pool()
    idx_mat = np.random.RandomState(2).permutation(12)[:8].reshape(2, 4)
    ref, ml = _learner(store, cuda), _learner(store, cuda)
    for rows in idx_mat:
        ref.train_step(take_tasks(pool, rows))
    ml.set_task_pool_compact(pool)
    before = dict(sized_spmm.launches)
    m = ml.train_steps_from_compact(idx_mat)
    assert all(sized_spmm.launches[k] > before[k] for k in before)
    assert m["meta_loss"].shape == (2,) and m["accs"].shape == (2, 3)
    for a, b in zip(ml.params, ref.params):
        assert torch.equal(a, b)


def test_pinned_host_window_fit_equals_compact_fit(cuda):
    store, ds = _tiny()
    base = Config(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=16, epoch=2,
                  task_num=4, update_step=2, update_step_test=2,
                  train_result_report_steps=2, agg="sized",
                  device_task_pool=True)
    compact = Trainer(base, store, ds, labels_num=3, device=cuda)
    r_c = compact.fit()
    host = Trainer(Config(**dict(vars(base), compact_pool_hbm_gb=0.0,
                                 host_pool_window=2)),
                   store, ds, labels_num=3, device=cuda)
    hit = []
    orig = host._fit_host_pool
    host._fit_host_pool = lambda *a: hit.append(1) or orig(*a)
    r_h = host.fit()
    assert hit == [1] and host.learner._copy_stream is not None
    for a, b in zip(compact.learner.params, host.learner.params):
        assert torch.equal(a, b)
    assert r_h == r_c and r_h.global_step == 6


def test_bf16_forward_on_cuda_matches_cpu(cuda):
    """A bf16 forward of a small packed batch (feat 8, hidden 16: both
    layers aggregate first) on the card against the port's own CPU bf16
    forward, every layer's activations and the logits, at chip_smoke.py's
    TOLS["bfloat16"] (the kernel sums in another order than the plain
    version). Layer 1 aggregates its float32 input with the float32
    kernel, as JAX's promotion keeps it; layer 2 with the bf16 one."""
    from gmeta_tpu_torch.meta.maml import batch_to
    from gmeta_tpu_torch.models import gcn

    store, ds = _tiny()
    batch = next(ds["train"].batches(4, shuffle=False))
    spec = build_model_config(Config(hidden_dim=16), store.feat_dim, 3)
    params = gcn.init_params(torch.Generator().manual_seed(5), spec)
    runs = []
    for device in ("cpu", cuda):
        sg = batch_to(batch, device).spt
        feats = torch.from_numpy(store.features).to(device)
        before = {k: dict(v) for k, v in sized_spmm.launches_by_dtype.items()}
        col = []
        logits = gcn.forward(tuple(p.to(device) for p in params), sg, feats,
                             spec, compute_dtype=torch.bfloat16, agg="sized",
                             collect=col)
        torch.cuda.synchronize()
        runs.append(([c.cpu() for c in col], logits.cpu()))
        launched = {k: {d: sized_spmm.launches_by_dtype[k][d] - before[k][d]
                        for d in v} for k, v in before.items()}
        if device == "cpu":
            assert not any(n for v in launched.values() for n in v.values())
        else:
            assert launched == {"float32": {"fwd": 1, "bwd": 0},
                                "bfloat16": {"fwd": 1, "bwd": 0}}, launched
    (want_col, want), (got_col, got) = runs
    for i, (a, b) in enumerate(zip(got_col, want_col)):
        assert a.dtype == b.dtype == torch.bfloat16, i
        torch.testing.assert_close(a.float(), b.float(), rtol=8e-3,
                                   atol=8e-3)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=8e-3, atol=8e-3)


# ---- densify and agg="auto" on the card -------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_densify_on_cuda_equals_cpu_bitwise_without_a_sync(cuda, dtype):
    """`densify` over three tasks on the card, with duplicates and pad
    edges in both forms (src 0 and, as the compact pool decodes them,
    src (B-1)*P; dst B*P-1), equals its CPU result bit for bit, and makes
    no host sync (a sync raises under set_sync_debug_mode("error"))."""
    rng = np.random.RandomState(0)
    T, B, P, n_real, n_pad = 3, 4, 256, 5000, 3000
    src = np.zeros((T, n_real + n_pad), np.int64)
    dst = np.full((T, n_real + n_pad), B * P - 1, np.int64)
    mask = np.zeros((T, n_real + n_pad), np.float32)
    for t in range(T):
        b = rng.randint(0, B, n_real)
        d = b * P + rng.randint(0, 200, n_real)
        s_ = b * P + rng.randint(0, 200, n_real)
        s_[: n_real // 5], d[: n_real // 5] = s_[-(n_real // 5):], \
            d[-(n_real // 5):]                      # duplicates
        order = np.argsort(d, kind="stable")
        src[t, :n_real], dst[t, :n_real] = s_[order], d[order]
        mask[t, :n_real] = 1.0
    src[1, n_real:] = (B - 1) * P
    args = [torch.from_numpy(a) for a in (src, dst, mask)]
    want = densify(*args, B, P, dtype=dtype)
    on_card = [a.to(cuda) for a in args]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = densify(*on_card, B, P, dtype=dtype)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.cpu().view(bits), want.view(bits))
    assert float(want.float().max()) >= 2.0


def test_trainer_auto_on_cuda_picks_by_the_card_rule(cuda, capsys):
    """A Trainer on the card with agg="auto" resolves it by the card's
    crossover (`agg_for` on CUDA), not by the JAX package's rule, which
    picks dense for this split; its meta-step then launches the kernel."""
    from gmeta_tpu_torch.data.pipeline import agg_for
    store, ds = _tiny()
    cfg = Config(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=16, task_num=4,
                 update_step=2, update_step_test=2, agg="auto")
    tr = Trainer(cfg, store, ds, labels_num=3, device=cuda)
    assert tr.agg == agg_for(ds["train"], cuda, tr.spec, "float32")
    assert tr.agg == "sized" and ds["train"].suggested_agg == "dense"
    assert "by the card's crossover" in capsys.readouterr().out
    before = dict(sized_spmm.launches)
    tr.learner.train_step(next(ds["train"].batches(4, shuffle=False)))
    torch.cuda.synchronize()
    assert all(sized_spmm.launches[d] > before[d] for d in before)


# ---- device extractor and remat on the card --------------------------------

def test_device_extractor_on_cuda_equals_cpu_uncapped(cuda):
    store, _ = synthetic_store(1, 600, 8, 4, 3, seed=5)
    g = store.graphs[0]
    kw = dict(h=2, sample_nodes=g.num_nodes, set_cap=4096, hop_budget=16384,
              edge_budget=16384, edge_out=8192, chunk=64)
    centers = np.arange(0, g.num_nodes, 3)
    got = DeviceExtractor(g, device=cuda, **kw).extract_arrays(centers)
    assert got.parents.is_cuda
    want = DeviceExtractor(g, device="cpu", **kw).extract_arrays(centers)
    assert not bool(got.overflow.any())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("first_order", [True, False])
def test_remat_train_step_equals_plain_on_cuda(cuda, first_order):
    store, ds = _tiny()
    batch = next(ds["train"].batches(4, shuffle=False))
    runs = []
    for remat in (False, True):
        ml = MetaLearner(build_model_config(Config(hidden_dim=16),
                                            store.feat_dim, 3), 3,
                         update_lr=0.05, meta_lr=1e-3, update_step=3,
                         update_step_test=2, seed=5, agg="sized",
                         first_order=first_order, remat=remat, device=cuda)
        ml.set_features(store.features)
        before = dict(sized_spmm.launches)
        m = ml.train_step(batch)
        torch.cuda.synchronize()
        runs.append((m, ml.params, {k: sized_spmm.launches[k] - before[k]
                                    for k in before}))
    (m0, p0, n0), (m1, p1, n1) = runs
    # recomputation launches the forward kernel again
    assert n1["fwd"] > n0["fwd"] > 0 and n1["bwd"] >= n0["bwd"] > 0
    torch.testing.assert_close(m1["meta_loss"], m0["meta_loss"], rtol=1e-6,
                               atol=0)
    for a, b in zip(p1[:-1], p0[:-1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)


# ---- the rectangular entry point (the edge-partitioned engine's gather) ----

def _rect(n_src, n_dst, H, dtype, device, seed=0):
    """A CSR pair of n_dst output rows over a table of n_src rows: every
    fifth row empty, row 1 with 3000 edges, the others 28 (the full graph's
    mean degree), sources drawn with repeats. x holds small integers, so
    every sum is exact in float32 and the comparisons are exact."""
    rng = np.random.RandomState(seed)
    counts = np.full(n_dst, 28)
    counts[::5] = 0
    counts[1] = 3000
    dst = np.repeat(np.arange(n_dst), counts)
    src = rng.randint(0, n_src, dst.size)
    pair = sized_spmm.csr_pair(src, dst, n_src, n_dst).to(device)
    x = torch.from_numpy(rng.randint(-8, 9, (n_src, H)).astype(np.float32))
    return pair, x.to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 5, 128, 256])
@pytest.mark.parametrize("n_src, n_dst", [(3000, 700), (400, 1500)])
def test_csr_gather_matches_plain(cuda, H, dtype, n_src, n_dst):
    pair, x = _rect(n_src, n_dst, H, dtype, cuda, seed=H)
    r = torch.from_numpy(np.random.RandomState(H + 1).randint(
        -8, 9, (n_dst, H)).astype(np.float32)).to(cuda, dtype)
    packed = dict(sized_spmm.launches)
    for count, (row_ptr, col), table, rows in (
            ("fwd", (pair.row_ptr, pair.col), x, n_dst),
            ("bwd", (pair.row_ptr_t, pair.col_t), r, n_src)):
        before = sized_spmm.csr_launches[count]
        got = sized_spmm.csr_gather(row_ptr, col, table, count)
        torch.cuda.synchronize()
        assert sized_spmm.csr_launches[count] == before + 1
        assert got.shape == (rows, H) and got.dtype == dtype
        assert torch.equal(got, sized_spmm.csr_plain(row_ptr, col, table))
    assert sized_spmm.launches == packed       # the packed counts stay


def test_csr_agg_backward_and_double_backward_match_plain(cuda):
    pair, x = _rect(900, 600, 16, torch.float32, cuda)
    x = x / 64                 # keeps the three inner steps from diverging

    def plain(t):
        return sized_spmm.csr_plain(pair.row_ptr, pair.col, t)

    def meta_grad(agg):
        w0 = torch.tensor(1.0, device=cuda, requires_grad=True)
        w = w0
        for _ in range(3):
            inner = agg(x * w).pow(2).mean()
            g, = torch.autograd.grad(inner, w, create_graph=True)
            w = w - 0.1 * g
        return torch.autograd.grad(agg(x * w).sum(), w0)[0]

    before = dict(sized_spmm.csr_launches)
    got = meta_grad(lambda t: sized_spmm.CsrAgg.apply(pair, t))
    assert all(sized_spmm.csr_launches[k] > before[k] for k in before)
    torch.testing.assert_close(got, meta_grad(plain), rtol=1e-4, atol=1e-6)
    # the first gradient, exactly (small integers): A^T r gathered over the
    # source CSR
    t = x.clone().requires_grad_()
    r = torch.randint(-8, 9, (600, 16), device=cuda).float()
    g, = torch.autograd.grad((sized_spmm.CsrAgg.apply(pair, t) * r).sum(), t)
    assert torch.equal(g, sized_spmm.csr_plain(pair.row_ptr_t, pair.col_t, r))


# ---- the full-graph body: column slabs and split rows -------------------------

def _long_rows(n_src, n_dst, counts, device, seed=0):
    """A CSR pair of n_dst rows of the given edge counts (cycled), sources
    drawn with repeats from n_src rows, edges in a shuffled order; rows of
    more than `CHUNK` (128) edges are split."""
    rng = np.random.RandomState(seed)
    counts = np.resize(np.asarray(counts), n_dst)
    dst = rng.permutation(np.repeat(np.arange(n_dst), counts))
    src = rng.randint(0, n_src, dst.size)
    return sized_spmm.csr_pair(src, dst, n_src, n_dst).to(device)


def _ints(shape, device, dtype, seed):
    g = np.random.RandomState(seed)
    return torch.from_numpy(g.randint(-8, 9, shape).astype(np.float32)).to(
        device, dtype)


def _slabs(monkeypatch, slab):
    """csr_gather's slab width forced to `slab` columns (None: the card's
    choice)."""
    if slab is None:
        monkeypatch.undo()
    else:
        monkeypatch.setattr(sized_spmm, "slab_width", lambda *a: slab)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 5, 50, 128, 256])
def test_full_graph_body_matches_plain_on_long_rows(cuda, monkeypatch, H,
                                                    dtype):
    """Rows of 0, 28, 3,000 and 100,000 edges (split at 128), at the width
    the card picks and at narrow slabs that do not divide H; small
    integers, so every sum is exact and the comparison exact."""
    pair = _long_rows(2000, 9, [0, 28, 3000, 100_000, 28], cuda, seed=H)
    x = _ints((2000, H), cuda, dtype, seed=H + 1)
    want = sized_spmm.csr_plain(pair.row_ptr, pair.col, x)
    for slab in (None, 8, 24, 48):
        _slabs(monkeypatch, slab)
        before = dict(sized_spmm.combine_launches)
        got = sized_spmm.csr_gather(pair.row_ptr, pair.col, x, "fwd",
                                    pair.split)
        torch.cuda.synchronize()
        assert sized_spmm.combine_launches["fwd"] == before["fwd"] + 1
        assert got.dtype == dtype and torch.equal(got, want), slab
    # the transpose: rows of about (100,000 + ...) / 2000 edges, unsplit
    r = _ints((9, H), cuda, dtype, seed=H + 2)
    got = sized_spmm.csr_gather(pair.row_ptr_t, pair.col_t, r, "bwd",
                                pair.split_t)
    assert torch.equal(got, sized_spmm.csr_plain(pair.row_ptr_t,
                                                 pair.col_t, r))


def _rowwise(row_ptr, col, x):
    """The packed path's body on a rectangular CSR, uncounted."""
    out = torch.empty((row_ptr.numel() - 1, x.shape[1]), dtype=x.dtype,
                      device=x.device)
    sized_spmm._run_kernel(row_ptr, col, x, out, row_ptr.numel() - 1, "")
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [5, 128, 256])
def test_full_graph_body_bitwise_equals_rowwise_body_and_itself(
        cuda, monkeypatch, H, dtype):
    """On random (not integer) inputs: rows that are not split sum in the
    same order as csr_gather_kernel, so bitwise equal to it at every slab
    width; two launches give the same bits, split rows included; and in
    float32 every row lies within rounding of the plain version."""
    pair = _long_rows(5000, 3000, [28, 0, 200, 3, 1500], cuda, seed=7)
    g = torch.Generator(device=cuda).manual_seed(H)
    x = torch.randn(5000, H, device=cuda, generator=g).to(dtype)
    plain = sized_spmm.csr_plain(pair.row_ptr, pair.col, x)
    # two float32 sums of a row's n terms, in any orders, differ by at most
    # 2 (n - 1) 2^-24 sum |x| (the classic bound on each one's error)
    n = (pair.row_ptr[1:] - pair.row_ptr[:-1]).float()[:, None]
    bound = 2 * (n - 1).clamp(min=0) * 2.0**-24 * sized_spmm.csr_plain(
        pair.row_ptr, pair.col, x.float().abs())
    ref = _rowwise(pair.row_ptr, pair.col, x)
    split = torch.zeros(3000, dtype=torch.bool, device=cuda)
    split[pair.split.rows.long()] = True
    assert split.any() and not split.all()
    for slab in (None, 8, 32, H):
        _slabs(monkeypatch, slab)
        got = sized_spmm.csr_gather(pair.row_ptr, pair.col, x, "fwd",
                                    pair.split)
        again = sized_spmm.csr_gather(pair.row_ptr, pair.col, x, "fwd",
                                      pair.split)
        assert torch.equal(got, again), slab
        assert torch.equal(got[~split], ref[~split]), slab
        if dtype == torch.float32:
            assert ((got - plain).abs() <= bound).all(), slab


def test_full_graph_body_on_misaligned_tables(cuda, monkeypatch):
    """x 4 bytes off a 16-byte boundary takes the scalar path, with split
    rows and slabs of 32 columns; the result is the same."""
    pair = _long_rows(700, 40, [28, 600, 0], cuda, seed=3)
    x = _ints((700, 128), cuda, torch.float32, seed=4)
    flat = torch.empty(x.numel() + 1, device=cuda)
    shifted = flat[1:].view(700, 128)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    _slabs(monkeypatch, 32)
    got = sized_spmm.csr_gather(pair.row_ptr, pair.col, shifted, "fwd",
                                pair.split)
    assert torch.equal(got, sized_spmm.csr_plain(pair.row_ptr, pair.col, x))


def test_split_rows_backward_and_double_backward_at_narrow_slabs(
        cuda, monkeypatch):
    """CsrAgg/CsrAggT through the split and slab paths (slab_width forced
    to one sector): gradient exact on integers, grad-of-grad close to the
    plain version's."""
    monkeypatch.setattr(sized_spmm, "slab_width", lambda *a: 8)
    pair = _long_rows(900, 600, [28, 700, 3], cuda, seed=5)
    assert pair.split.rows.numel() > 0
    x = _ints((900, 16), cuda, torch.float32, seed=6) / 64

    def meta_grad(agg):
        w0 = torch.tensor(1.0, device=cuda, requires_grad=True)
        w = w0
        for _ in range(3):
            inner = agg(x * w).pow(2).mean()
            g, = torch.autograd.grad(inner, w, create_graph=True)
            w = w - 0.1 * g
        return torch.autograd.grad(agg(x * w).sum(), w0)[0]

    before = dict(sized_spmm.combine_launches)
    got = meta_grad(lambda t: sized_spmm.CsrAgg.apply(pair, t))
    assert sized_spmm.combine_launches["fwd"] > before["fwd"]
    want = meta_grad(lambda t: sized_spmm.csr_plain(pair.row_ptr, pair.col,
                                                    t))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)
    # the transpose's gradient is the forward gather, split rows and all
    t = _ints((600, 16), cuda, torch.float32, seed=7).requires_grad_()
    r = _ints((900, 16), cuda, torch.float32, seed=8)
    g, = torch.autograd.grad((sized_spmm.CsrAggT.apply(pair, t) * r).sum(),
                             t)
    assert torch.equal(g, sized_spmm.csr_plain(pair.row_ptr, pair.col, r))


def test_plan_is_built_when_missing_and_raises_on_a_plan_elsewhere(cuda):
    pair = _long_rows(300, 20, [400, 5], cuda, seed=9)
    x = _ints((300, 8), cuda, torch.float32, seed=10)
    got = sized_spmm.csr_gather(pair.row_ptr, pair.col, x)
    assert torch.equal(got, sized_spmm.csr_plain(pair.row_ptr, pair.col, x))
    with pytest.raises(ValueError):
        sized_spmm.csr_gather(pair.row_ptr, pair.col, x, "fwd",
                              pair.split.to("cpu"))
    assert sized_spmm.l2_bytes(x.device.index or 0) >= 1 << 20


# ---- the combine kernel alone -----------------------------------------------

def _combine_case(per, H, device, seed, n_out=None):
    """A row plan whose split rows own `per` chunks each (rows spread over
    out), float32 partial sums of mixed scales (normal values times
    e^(3 z) per chunk: another summation order gives other bits), and
    n_out rows of out."""
    rng = np.random.RandomState(seed)
    per = np.asarray(per)
    n_out = n_out or 3 * len(per) + 2
    rows = np.sort(rng.choice(n_out, len(per), replace=False))
    chunk_ptr = np.concatenate([[0], np.cumsum(per)])
    chunk_row = np.repeat(rows, per)
    split = sized_spmm.RowSplit(*(
        torch.from_numpy(a.astype(np.int32)).to(device) for a in (
            rows, chunk_ptr, chunk_row, np.zeros_like(chunk_row))), 128)
    partial = (rng.randn(per.sum(), H)
               * np.exp(3 * rng.randn(per.sum(), 1))).astype(np.float32)
    return split, torch.from_numpy(partial).to(device), n_out


def _combine_checked(split, partial, out):
    """The kernel into a copy of out (a sentinel fill), held bitwise
    against combine_plain on the CPU (chunk order, one rounding; rows not
    split left as they were), one launch counted; returns its result."""
    before = dict(sized_spmm.combine_launches)
    got = sized_spmm.csr_combine(split, partial, out)
    torch.cuda.synchronize()
    assert sized_spmm.combine_launches["fwd"] == before["fwd"] + 1
    want = sized_spmm.combine_plain(split.to("cpu"), partial.cpu(),
                                    out.new_full(out.shape, 7.0).cpu())
    assert torch.equal(got.cpu(), want)
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H", [1, 5, 50, 128, 256])
def test_combine_kernel_bitwise_equals_plain(cuda, H, dtype):
    """Rows of 2, 3, 17 and 800 chunks (and 1, 16, 128 and 129: a light
    row's round of loads, and either side of the heavy rows, which
    blocks sum a band of columns each), at every preset width and both
    dtypes: bitwise combine_plain's, the other rows untouched, and two
    launches give the same bits."""
    split, partial, n_out = _combine_case([2, 3, 17, 800, 1, 16, 128, 129],
                                          H, cuda, seed=H)
    out = torch.full((n_out, H), 7.0, dtype=dtype, device=cuda)
    got = _combine_checked(split, partial, out.clone())
    again = _combine_checked(split, partial, out.clone())
    assert torch.equal(got, again)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_kernel_on_misaligned_views(cuda, dtype):
    """partial and out as views at an offset off their 16-byte boundary
    (one element in): the kernel takes its scalar path there, with the
    same bits as combine_plain and as the aligned launch."""
    split, partial, n_out = _combine_case([2, 17, 800], 128, cuda, seed=3)
    aligned = _combine_checked(
        split, partial, torch.full((n_out, 128), 7.0, dtype=dtype,
                                   device=cuda))
    flat = torch.empty(partial.numel() + 1, device=cuda)
    shifted = flat[1:].view(partial.shape)
    shifted.copy_(partial)
    flat_out = torch.full((n_out * 128 + 1,), 7.0, dtype=dtype, device=cuda)
    out = flat_out[1:].view(n_out, 128)
    assert shifted.data_ptr() % 16 and out.data_ptr() % 16
    got = _combine_checked(split, shifted, out)
    assert torch.equal(got, aligned)


@pytest.mark.parametrize("per", [[1], [5], [800]])
def test_combine_kernel_single_split_row(cuda, per):
    """One split row (one block; 1, 5 or 800 chunks) in a table of 4,000
    rows, float32 and bf16: every other row keeps its sentinel."""
    for dtype in (torch.float32, torch.bfloat16):
        split, partial, _ = _combine_case(per, 256, cuda, seed=per[0],
                                          n_out=4000)
        out = torch.full((4000, 256), 7.0, dtype=dtype, device=cuda)
        got = _combine_checked(split, partial, out)
        others = torch.ones(4000, dtype=torch.bool, device=cuda)
        others[split.rows.long()] = False
        assert (got[others] == 7.0).all()


@pytest.mark.parametrize("H", [257, 1028])
def test_combine_kernel_heavy_rows_in_column_bands(cuda, H):
    """Widths past one block's lanes (257 scalars, 257 float4s): a heavy
    row's bands, the last one narrower, and a light row's lanes pass
    after pass; bitwise combine_plain's."""
    split, partial, n_out = _combine_case([3, 200, 129, 128], H, cuda,
                                          seed=H)
    for dtype in (torch.float32, torch.bfloat16):
        _combine_checked(split, partial, torch.full(
            (n_out, H), 7.0, dtype=dtype, device=cuda))


def test_combine_kernel_finds_heavy_rows_among_many(cuda):
    """40,000 split rows, more than the heavy blocks look at in one pass
    (a block per SM, 256 rows each): heavy rows at the start, the middle
    and the end of the plan, and of 129 chunks, just past the
    threshold."""
    per = np.full(40_000, 2)
    per[[0, 17, 20_000, 35_001, 39_999]] = [300, 129, 200, 800, 130]
    split, partial, n_out = _combine_case(per, 8, cuda, seed=11,
                                          n_out=80_000)
    _combine_checked(split, partial, torch.full((n_out, 8), 7.0,
                                                device=cuda))


# ---- the collectives and the launch model on the card -----------------------

def test_collectives_at_world_one_on_nccl_and_gloo(cuda, monkeypatch):
    """Each collective's autograd Function on a world of one, through NCCL
    (the all-to-all also started asynchronously) and through a gloo group,
    which stages CUDA tensors through host memory: the identity, with the
    gradients and second gradients of the identity."""
    import torch.distributed as dist
    from gmeta_tpu_torch.parallel import collectives as coll
    from gmeta_tpu_torch.parallel.mesh import init_distributed, make_mesh
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert init_distributed("nccl", cuda)
    try:
        mesh = make_mesh(1, 1, device=cuda)
        gloo = dist.new_group([0], backend="gloo")
        gen = torch.Generator(device=cuda).manual_seed(0)
        x0, w, v = (torch.randn(1, 6, 5, device=cuda, generator=gen)
                    for _ in range(3))

        def via(fn):
            x = x0.clone().requires_grad_()
            y = fn(x)
            g, = torch.autograd.grad((y * y * w).sum(), x, create_graph=True)
            gg, = torch.autograd.grad((g * v).sum(), x)
            return y.detach(), g.detach(), gg

        want = via(lambda x: x)
        for group in (mesh.world, gloo):
            def a2a_async(x, group=group):
                pending = coll._Pending()
                y = coll._AllToAll.apply(x, group, pending)
                pending.wait()
                return y
            for fn in (lambda x, group=group: coll._AllReduceSum.apply(
                           x, group),
                       lambda x, group=group: coll._AllToAll.apply(
                           x, group, None),
                       a2a_async):
                for a, b in zip(via(fn), want):
                    assert a.is_cuda and torch.equal(a, b)
        mesh.barrier()
    finally:
        dist.destroy_process_group()


def test_nccl_ranks_sharing_a_card_raise(cuda, monkeypatch):
    """More ranks on the host than cards, under NCCL, raise before any
    process group exists; so does a rank with no card of its own; gloo on
    a shared card runs only when asked for."""
    from gmeta_tpu_torch.run.train import rank_device
    n = torch.cuda.device_count()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(n + 1))
    monkeypatch.setenv("LOCAL_RANK", "0")
    with pytest.raises(ValueError, match="NCCL refuses"):
        rank_device("cuda:0", "nccl")
    with pytest.raises(ValueError, match="NCCL refuses"):
        rank_device(None, None)
    with pytest.raises(ValueError, match="NCCL refuses"):
        rank_device("cuda:0", None)
    assert rank_device("cuda:0", "gloo") == (torch.device("cuda:0"), "gloo")
    monkeypatch.setenv("LOCAL_RANK", str(n))
    with pytest.raises(RuntimeError, match="no card of its own"):
        rank_device(None, None)


@pytest.mark.parametrize("agg", ["sized", "dense"])
def test_spans_on_cuda_are_the_cpu_tree_and_leave_the_bits(cuda, agg):
    """Under a profiler of the card's activity alone (as the benchmark's
    traced window runs one), a compact call on CUDA records the same spans
    under the same parents as on the CPU, though the backward runs on the
    autograd engine's own thread there; each span's device time is read;
    theta is the same bits as without the profiler."""
    from torch.profiler import ProfilerActivity, profile

    from gmeta_tpu_torch.utils import metrics
    store, ds = _tiny()
    pool = ds["train"].stacked_pool()
    idx_mat = np.random.RandomState(2).permutation(12)[:8].reshape(2, 4)

    def run(device, activities):
        ml = MetaLearner(build_model_config(Config(hidden_dim=16),
                                            store.feat_dim, 3), 3,
                         update_lr=0.05, meta_lr=1e-3, update_step=3,
                         update_step_test=2, seed=5, agg=agg, remat=True,
                         device=device)
        ml.set_features(store.features)
        ml.set_task_pool_compact(pool)
        metrics.clear_spans()
        if activities is None:
            ml.train_steps_from_compact(idx_mat)
            return ml.snapshot(), []
        with profile(activities=activities):
            ml.train_steps_from_compact(idx_mat)
            torch.cuda.synchronize()
        return ml.snapshot(), metrics.spans()

    def tree(window):
        return sorted((s.name, window[s.parent].name if s.parent >= 0
                       else "") for s in window)
    _, cpu = run("cpu", [ProfilerActivity.CPU])
    theta, gpu = run(cuda, [ProfilerActivity.CUDA])
    plain, _ = run(cuda, None)
    assert gpu and tree(gpu) == tree(cpu)
    for a, b in zip(theta, plain):
        assert torch.equal(a, b)
    steps = [i for i, s in enumerate(gpu) if s.name == "step"]
    assert len(steps) == 2
    for i in steps:
        kids = sum(s.device_ms for s in gpu if s.parent == i)
        assert 0 < kids <= gpu[i].device_ms * 1.001
    assert all(s.device_ms > 0 for s in gpu if s.name == "agg")


def test_stream_clock_marks_the_stream_current_at_each_mark(cuda):
    """StreamClock keeps the current stream's Python object between marks,
    and builds it again when another stream becomes current."""
    from gmeta_tpu_torch.utils.metrics import StreamClock
    clock = StreamClock(torch.device("cuda"))
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(1000)           # load the kernel before timing
    torch.cuda.synchronize()
    a = clock.mark()
    with torch.cuda.stream(side):
        torch.cuda._sleep(50_000_000)     # tens of ms, on the side stream
        b = clock.mark()
    c = clock.mark()
    torch.cuda.synchronize()
    assert clock._stream[2] == torch.cuda.current_stream()
    # b waited for the sleep on the side stream, c did not
    assert StreamClock.seconds(a, b) > 0.01
    assert 0 <= StreamClock.seconds(a, c) < 0.005
