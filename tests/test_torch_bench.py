"""The port's throughput benchmark (gmeta_tpu_torch/bench.py) against the
JAX package's (bench.py at the repository root): the synthesized pools
byte for byte, a cut replay's theta against the JAX MetaLearner's pool and
compact steps and its first bf16 inner gradient against JAX's
(parity_torch/bf16_stages.py), the FLOP count, main()'s line and exit
code; and the shared-adjacency aggregation (ops/sized_spmm.py
aggregate_sized_shared) against the JAX batching rule of a task-invariant
adjacency, in interpret mode."""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmeta_tpu.config import Config as JConfig
from gmeta_tpu.config import build_model_config as j_build_model_config
from gmeta_tpu.meta.maml import MetaLearner as JMetaLearner
from gmeta_tpu.ops.pallas_spmm import aggregate_sized as j_aggregate_sized
from gmeta_tpu_torch import bench
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.scripts import bench_window

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import bench as jbench  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "parity_torch"))
import bf16_stages  # noqa: E402

torch.set_num_threads(2)

META_LR = 1e-3


def _assert_sets_equal(got, want):
    assert type(got).__name__ == type(want).__name__ == "SubgraphSet"
    for name, a, b in zip(want._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert np.array_equal(a, b), name


@pytest.mark.parametrize("link", [False, True])
def test_synth_set_is_byte_identical(link):
    args = (128, 5, 2000, 9, 3, 0.55, 20_000, 1234.7, link)
    got = bench._synth_set(np.random.RandomState(4), *args)
    want = jbench._synth_set(np.random.RandomState(4), *args)
    _assert_sets_equal(got, want)
    assert (got.centers[:, 0] != got.centers[:, 1]).any() == link


@pytest.mark.parametrize("name", list(bench.SHAPES))
def test_pool_from_parity_is_byte_identical(monkeypatch, name):
    monkeypatch.setattr(jbench, "POOL", 2)
    assert bench.SHAPES == jbench.SHAPES
    assert bench.REPLICA_META == jbench.REPLICA_META
    rec = bench._load_parity(name)
    assert rec == jbench._load_parity(name) and rec is not None
    s = bench.SHAPES[name]
    feats, pool, mean_edges, agg = bench._pool_from_parity(name, s, rec, 2)
    jfeats, jpool, jmean_edges, jagg = jbench._pool_from_parity(name, s, rec)
    assert feats.dtype == jfeats.dtype and np.array_equal(feats, jfeats)
    assert mean_edges == jmean_edges and agg == jagg
    assert pool.spt.node_gid.shape[0] == 2
    _assert_sets_equal(pool.spt, jpool.spt)
    _assert_sets_equal(pool.qry, jpool.qry)


def test_synth_set_raises_where_the_gids_would_leave_the_table():
    P = 128
    with pytest.raises(ValueError, match="clustered gids"):
        bench._synth_set(np.random.RandomState(0), P, 2, 100, 4, 2, 0.5,
                         4 * P, 50, False)
    sg = bench._synth_set(np.random.RandomState(0), P, 2, 100, 4, 2, 0.5,
                          4 * P + 1, 50, False)
    assert sg.node_gid.max() <= 4 * P


def test_load_parity_falls_back_without_a_record():
    assert bench._load_parity("no_such_recipe") is None


# --- a cut replay against the JAX MetaLearner --------------------------------

CUT = dict(hidden=16, task_num=2, update_step=2)
STEPS, POOL = 2, 4


def _record(compact, agg, P=128):
    """A record of the shape of parity/<recipe>.json at P = 128."""
    return {"buckets": {"P_spt": P, "B_spt": 2, "E_spt": 1536,
                        "P_qry": P, "B_qry": 3, "E_qry": 2560},
            "mean_bin_fill": 0.6, "agg": agg, "tasks_per_s": 100.0,
            "edges_per_s": 250_000.0,
            "preset_overrides": {"device_task_pool": compact}}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compact, agg", [(False, "dense"), (True, "sized")])
def test_cut_replay_matches_jax(monkeypatch, compact, agg, dtype):
    """bench_shape's run at hidden 16, 2 tasks, 2 inner steps, 2 meta-steps,
    P = 128, from the JAX seed-0 theta, against the JAX MetaLearner's
    train_steps_from_pool (full pool) or train_steps_from_compact (compact
    pool) on the same pool and indices: both meta-losses at
    tests/test_torch_meta.py's tolerances, and theta after the run at them
    too in float32 (the head bias bounded as there).

    In bf16 an entry of theta may part: Adam's first steps move every entry
    by about meta_lr times the sign of its gradient, and a gradient near
    zero takes its sign from rounding. The port rounds every bf16 value
    where JAX's program does (layer 1 in float32, its output rounded), but
    XLA's compile of that program on the CPU keeps some bf16 products in
    float32 where float32 consumes them, sums each bias gradient in a bf16
    accumulator, and reorders Adam's float32 arithmetic
    (parity_torch/bf16_stages.py attributes each share). So at most 3% of
    theta's entries may part beyond float32's tolerance (1.8% do), each by
    no more than two Adam steps in each package can move it apart (each
    step at most 1.0014 meta_lr: |m_hat| / sqrt(v_hat) after two steps)."""
    name = "tissue_ppi"
    s = dict(bench.SHAPES[name], **CUT)
    rec = _record(compact, agg)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    cfg = JConfig(h=2, hidden_dim=s["hidden"], task_setup="Shared")
    n_out = bench.REPLICA_META[name]["n_out"]
    spec = j_build_model_config(cfg, bench.REPLICA_META[name]["feat"], n_out)
    j = JMetaLearner(spec, n_out, update_lr=0.01, meta_lr=META_LR,
                     update_step=s["update_step"],
                     update_step_test=s["update_step"], remat=False,
                     compute_dtype=jdt, seed=0, track_curve=False, agg=agg)
    init = [np.array(p) for p in j.params]

    monkeypatch.setattr(jbench, "POOL", POOL)
    jfeats, jpool, _, _ = jbench._pool_from_parity(name, s, rec)
    j.set_features(jfeats)
    rng = np.random.RandomState(0)
    idx_mat = np.stack([rng.choice(POOL, s["task_num"], replace=False)
                        for _ in range(STEPS)]).astype(np.int32)
    if compact:
        j.set_task_pool_compact(jpool)
        jm = j.train_steps_from_compact(idx_mat)
    else:
        j.set_task_pool(jpool)
        jm = j.train_steps_from_pool(idx_mat)

    out, ml = bench.run_shape(name, s, device="cpu", steps=STEPS, pool=POOL,
                              rec=rec, dtype=getattr(torch, dtype),
                              init=init)
    assert out["agg"] == agg and out["pool_mode"] == (
        "compact" if compact else "full")
    np.testing.assert_allclose(
        [out["meta_loss_first"], out["meta_loss_last"]],
        np.asarray(jm["meta_loss"], np.float32), rtol=1e-4, atol=1e-5)
    apart = 2 * STEPS * META_LR * 1.0014     # two packages' Adam steps
    parted = []
    for i, (a, b) in enumerate(zip(j.params, ml.params)):
        a, b = np.asarray(a), b.detach().numpy()
        if i == len(init) - 1:     # the head bias (tests/test_torch_meta.py)
            for x in (a, b):
                assert np.abs(x - init[i]).max() <= STEPS * META_LR * 1.001
        elif dtype == "float32":
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5,
                                       err_msg=f"param {i}")
        else:
            off = np.abs(b - a) > 1e-5 + 1e-4 * np.abs(a)
            assert np.abs(b - a).max() <= apart, f"param {i}"
            parted.append(off.ravel())
    if dtype == "bfloat16":
        share = np.concatenate(parted).mean()
        assert share <= 0.03, share


@pytest.mark.parametrize("agg", ["dense", "sized"])
def test_cut_inner_gradient_matches_jax(agg):
    """Stage (b) of parity_torch/bf16_stages.py: the support loss and the
    gradient of one bf16 inner step from theta on the cut replay's first
    meta-batch, against the JAX inner step jitted and vmapped over the
    tasks as MetaLearner runs it. The losses are float32 and agree to an
    ulp (the head's product sums in another order).

    Compiled as XLA compiles it by default, JAX keeps some bf16 products
    in float32 where a float32 product consumes them (the cotangent of
    `h * norm` into the transposed matmul, for one), so 46% of the
    gradient's entries part, each by a few bf16 ulps. Compiled with
    xla_allow_excess_precision off, XLA rounds every bf16 value the
    program names, as the port does: then every weight's gradient is equal
    bit for bit, and only the GraphConv biases' part (0.7% of the
    entries), whose reduction XLA sums in a bf16 accumulator where the
    port sums in float32 and rounds once. The head bias's gradient is
    rounding noise (tests/test_torch_meta.py) and is bounded alone."""
    shares = {}
    for honour in (False, True):
        (jl, jg), (tl, tg) = bf16_stages.inner_gradients(agg, honour=honour)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-6)
        head_b = len(jg) - 1
        assert np.abs(tg[head_b].numpy()).max() < 1e-6
        assert np.abs(np.asarray(jg[head_b])).max() < 1e-6
        body = range(head_b)
        for i in body:
            a, b = np.asarray(jg[i]), tg[i].numpy()
            # a few bf16 ulps of the largest entry
            assert np.abs(b - a).max() <= 2 ** -6 * np.abs(a).max(), i
            if honour and i % 2 == 0:              # the weights
                np.testing.assert_array_equal(b, a, err_msg=f"param {i}")
        shares[honour] = bf16_stages.share((jg[i], tg[i]) for i in body)
    assert shares[False] <= 0.47, shares
    assert shares[True] <= 0.01, shares


def _flops(agg, **cut):
    s = dict(bench.SHAPES["tissue_ppi"], **dict(CUT, **cut))
    return bench.bench_shape("tissue_ppi", s, agg=agg, device="cpu",
                             steps=1, pool=POOL, rec=_record(True, "dense"))


def test_flops_count_every_step_equally_on_both_paths():
    """flops_per_step is the same for dense (torch.bmm, seen by the FLOP
    counter) and sized (the kernel's plain version, unseen), is affine in
    update_step and proportional to task_num, and its aggregation part is
    2 S P^2 H for every forward and transposed call: per inner step the
    support's two layers forward and back, the last step's support once
    more for the meta-gradient, and the query's two layers forward and
    back."""
    f = {(agg, u, t): _flops(agg, update_step=u, task_num=t)
         for agg in ("dense", "sized") for u, t in ((1, 2), (2, 2), (3, 2),
                                                    (2, 1))}
    for key in {k[1:] for k in f}:
        d, z = f[("dense",) + key], f[("sized",) + key]
        for k in ("flops_per_step", "useful_flops", "agg_flops_per_step"):
            assert d[k] == z[k] > 0, (key, k)
        assert d["useful_flops"] < d["flops_per_step"]
        assert d["mfu"] is None and d["peak_gb"] is None
    fl = {k[1:]: v["flops_per_step"] for k, v in f.items()
          if k[0] == "dense"}
    assert fl[(3, 2)] - fl[(2, 2)] == fl[(2, 2)] - fl[(1, 2)] > 0
    assert fl[(2, 2)] == 2 * fl[(2, 1)]
    b = _record(True, "dense")["buckets"]
    P, H = b["P_spt"], CUT["hidden"]
    for (agg, u, t), r in f.items():
        calls = (4 * u + 2) * b["B_spt"] + 4 * b["B_qry"]
        assert r["agg_flops_per_step"] == 2 * t * calls * P * P * H


def _main(capsys, monkeypatch):
    """main() on the CPU, cut: firstmm_db alone at hidden 8, one task, one
    inner step, one meta-step, a pool of 2, extraction on 1,500 nodes."""
    cut = dict(bench.SHAPES["firstmm_db"], hidden=8, task_num=1,
               update_step=1)
    monkeypatch.setattr(bench, "SHAPES", {"firstmm_db": cut})
    monkeypatch.setattr(bench, "POOL", 2)
    monkeypatch.setattr(bench, "MEASURE_STEPS", 1)
    monkeypatch.setattr(bench, "bench_extraction", functools.partial(
        bench.bench_extraction, nodes=1500))
    rc = bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_main_prints_one_json_line_with_the_jax_keys(capsys, monkeypatch):
    rc, line = _main(capsys, monkeypatch)
    assert rc == 0
    for key in ("metric", "value", "unit", "vs_baseline", "shapes",
                "extraction"):
        assert key in line
    assert line["metric"] == "meta_train_tasks_per_s"
    assert line["steps"] == 1 and line["pool"] == 2
    r = line["shapes"]["firstmm_db"]
    for key in ("tasks_per_s", "agg", "geometry", "vs_baseline",
                "edges_per_s", "mfu", "pad_waste", "compile_s", "step_s",
                "buckets", "production_tasks_per_s", "peak_gb",
                "flops_per_step", "useful_flops"):
        assert key in r, key
    assert r["agg"] == "dense" and r["sized"]["agg"] == "sized"
    assert r["flops_per_step"] == r["sized"]["flops_per_step"]
    assert r["meta_loss_first"] == pytest.approx(
        r["sized"]["meta_loss_first"], rel=8e-3)
    assert r["production_tasks_per_s"] == json.load(open(os.path.join(
        bench.ROOT, "parity_torch", "firstmm_db.json")))["tasks_per_s"]
    ex = line["extraction"]
    assert ex["device_extract_per_s"] > 0 and ex["native_extract_per_s"] > 0


@pytest.mark.parametrize("failing", ["bench_shape", "bench_extraction"])
def test_main_exits_non_zero_when_a_part_fails(capsys, monkeypatch, failing):
    def fail(*a, **k):
        raise RuntimeError("a kernel failed to launch")
    monkeypatch.setattr(bench, failing, fail)
    other = {"bench_shape": "bench_extraction",
             "bench_extraction": "bench_shape"}[failing]
    monkeypatch.setattr(bench, other, lambda *a, **k: {"agg": "sized"})
    rc, line = _main(capsys, monkeypatch)
    assert rc == 1
    part = (line["shapes"]["firstmm_db"] if failing == "bench_shape"
            else line["extraction"])
    assert "a kernel failed" in part["error"]


def test_main_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_window.main([])


def test_bench_window_writes_every_reading(monkeypatch, tmp_path):
    """scripts/bench_window.py, cut: firstmm_db at hidden 8, one task, one
    inner step, windows of 1 and 2 meta-steps in turns, twice."""
    cut = dict(bench.SHAPES["firstmm_db"], hidden=8, task_num=1,
               update_step=1)
    monkeypatch.setattr(bench, "SHAPES", {"firstmm_db": cut})
    monkeypatch.setattr(bench, "POOL", 2)
    monkeypatch.setattr(bench_window, "SHAPES", ("firstmm_db",))
    monkeypatch.setattr(bench_window, "WINDOWS", (1, 2))
    monkeypatch.setattr(bench_window, "REPEATS", 2)
    out = tmp_path / "w.json"
    res = bench_window.main(["--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    row = res["shapes"]["firstmm_db"]
    assert row["agg"] == "dense" and list(row["windows"]) == ["1", "2"]
    for r in row["windows"].values():
        assert len(r["tasks_per_s"]) == len(r["step_s"]) == 2
        assert r["busy_share"] == [None, None]
        assert r["spread"] == max(r["tasks_per_s"]) / min(r["tasks_per_s"])


# --- the shared-adjacency aggregation ----------------------------------------

def _shared_case(T=3, S=2, P=128, H=8, seed=7):
    """Edges inside each bin's live rows (a fifth duplicated), pad edges
    after them; h (T, S, P, H). Returns the port's graph, the JAX dense A
    and sizes, and h."""
    rng = np.random.RandomState(seed)
    sizes = rng.randint(60, P + 1, S)
    A = np.zeros((S, P, P), np.float32)
    src, dst = [], []
    for s, n in enumerate(sizes):
        d, c = np.nonzero(rng.rand(n, n) < 0.05)
        reps = 1 + (rng.rand(d.size) < 0.2)
        d, c = np.repeat(d, reps), np.repeat(c, reps)
        np.add.at(A[s], (d, c), 1.0)
        dst.append(s * P + d)
        src.append(s * P + c)
    n_pad = 8
    src = np.concatenate(src + [np.zeros(n_pad, np.int64)])
    dst = np.concatenate(dst + [np.full(n_pad, S * P - 1)])
    mask = np.concatenate([np.ones(src.size - n_pad), np.zeros(n_pad)])
    graph = sp.sized_graph(torch.from_numpy(src), torch.from_numpy(dst),
                           torch.from_numpy(mask.astype(np.float32)), S, P)
    h = rng.randn(T, S, P, H).astype(np.float32)
    return graph, A, sizes, h


def test_shared_aggregation_matches_the_jax_batching_rule():
    graph, A, sizes, h = _shared_case()
    Aj, sz = jnp.asarray(A), jnp.asarray(sizes, jnp.int32)
    f = jax.vmap(lambda x: j_aggregate_sized(Aj, x, sz, True))
    want = jax.jit(f)(jnp.asarray(h))
    got = sp.aggregate_sized_shared(graph, torch.from_numpy(h))
    assert got.shape == h.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    # and its gradient, through SizedAggT at width T * H, against the JAX
    # transpose under the same batching rule
    w = np.random.RandomState(3).randn(*h.shape).astype(np.float32)
    jg = jax.grad(lambda x: (f(x) * w).sum())(jnp.asarray(h))
    ht = torch.from_numpy(h).requires_grad_(True)
    (tg,) = torch.autograd.grad(
        (sp.aggregate_sized_shared(graph, ht) * torch.from_numpy(w)).sum(),
        ht)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-5)


def test_shared_aggregation_equals_separate_calls_with_its_gradients():
    graph, _, _, h = _shared_case(T=4, H=5, seed=2)
    ht = torch.from_numpy(h.copy()).requires_grad_(True)
    hs = torch.from_numpy(h.copy()).requires_grad_(True)
    got = sp.aggregate_sized_shared(graph, ht)
    want = torch.stack([sp.aggregate_sized(graph, hs[t])
                        for t in range(h.shape[0])])
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    rng = np.random.RandomState(1)
    w, v = (torch.from_numpy(rng.randn(*h.shape).astype(np.float32))
            .requires_grad_(True) for _ in range(2))
    (g1,) = torch.autograd.grad((got * w).sum(), ht, create_graph=True)
    (g2,) = torch.autograd.grad((want * w).sum(), hs, create_graph=True)
    torch.testing.assert_close(g1, g2, rtol=1e-6, atol=1e-6)
    # double backward: d/dw of the gradient runs the forward call again
    (gg1,) = torch.autograd.grad((g1 * v).sum(), w)
    (gg2,) = torch.autograd.grad((g2 * v).sum(), w)
    torch.testing.assert_close(gg1, gg2, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(gg1, sp.aggregate_sized_shared(graph, v),
                               rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="want h"):
        sp.aggregate_sized_shared(graph, ht[0])
