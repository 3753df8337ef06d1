"""The port's measurement scripts (gmeta_tpu_torch/scripts/) against the JAX
package's (scripts/bench_*.py): their synthetic data drawn bitwise alike
(but for the two repaired entries of `synth_bucket`), the aggregation
paths they time against the JAX package's on one bucket, bench_transfer's
compact pool and stream steps against each other and against the JAX
MetaLearner, each script's main() on the CPU at a tiny size, and the
shared bounds of utils/cardtime.py; and the port's own: bench_kernels'
crossover sweep, its count of a meta-step's aggregation calls against
the code's, and bench_agg."""

import json
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmeta_tpu.data.pack import SubgraphSet as JSubgraphSet
from gmeta_tpu.data.pack import TaskBatch as JTaskBatch
from gmeta_tpu.meta import maml as jmaml
from gmeta_tpu.ops import spmm as jspmm
from gmeta_tpu.ops.pallas_spmm import sized_reference
from gmeta_tpu_torch import bench
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data import replicas, repack
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner
from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.ops import spmm
from gmeta_tpu_torch.scripts import (bench_agg, bench_edgepart, bench_edges,
                                     bench_kernels, bench_pallas_spmm,
                                     bench_transfer)
from gmeta_tpu_torch.utils import cardtime

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import bench_edges as jbench_edges  # noqa: E402
import bench_kernels as jbench_kernels  # noqa: E402
import bench_pallas_spmm as jbench_pallas_spmm  # noqa: E402
import bench_transfer as jbench_transfer  # noqa: E402

torch.set_num_threads(2)

TOLS = {"f32": dict(rtol=1e-5, atol=1e-4), "bf16": dict(rtol=8e-3,
                                                        atol=8e-3)}


# --- the synthetic data, drawn as the JAX scripts draw it --------------------

def test_load_shapes_match_jax():
    assert bench_kernels.load_shapes() == jbench_kernels.load_shapes()
    assert bench_kernels.FEAT_HID == jbench_kernels.FEAT_HID
    assert bench_kernels.FALLBACK == jbench_kernels.FALLBACK


@pytest.mark.parametrize("P,B,E,H,fill", [(16, 2, 400, 3, 0.9),
                                          (64, 3, 700, 5, 0.5)])
def test_synth_bucket_matches_jax_but_the_two_repairs(P, B, E, H, fill):
    """Every array bitwise equal to the JAX script's draw but two: A
    counts a duplicate edge as often as the edge list holds it (the JAX
    script's `A[b, d, s] += 1.0` counts it once), and the mask zeroes
    exactly the pad edges, the last `pad` after the stable sort (the JAX
    script's also zeroes the real edges into the last slot, B*P - 1)."""
    A, h, sizes, src, dst, mask = bench_kernels.synth_bucket(
        P, B, E, H, fill, np.random.RandomState(3))
    jA, jh, jsizes, jsrc, jdst, jmask = jbench_kernels.synth_bucket(
        P, B, E, H, fill, np.random.RandomState(3))
    for a, b in ((h, jh), (sizes, jsizes), (src, jsrc), (dst, jdst)):
        assert a.dtype == b.dtype and np.array_equal(a, b)

    n_real = int(np.sum(np.minimum(E // B, sizes.astype(np.int64) * 10)))
    assert np.array_equal(mask, (np.arange(E) < n_real).astype(np.float32))
    last = (dst == B * P - 1) & (np.arange(E) < n_real)
    assert np.array_equal(jmask, np.where(last, 0.0, mask))

    counts = np.zeros((B, P, P), np.float32)
    live = mask > 0
    b_, d_, s_ = dst[live] // P, dst[live] % P, src[live] % P
    np.add.at(counts, (b_, d_, s_), 1.0)
    assert np.array_equal(A, counts)
    assert np.array_equal(jA, (counts > 0).astype(np.float32))
    # the dense operand is what densify makes of the edge list
    assert np.array_equal(A, spmm.densify(
        *(torch.from_numpy(x) for x in (src, dst, mask)), B, P).numpy())
    if P == 16:      # dense bins: both repairs are exercised
        assert (A > 1).any() and last.any()


def test_mk_matches_jax():
    S, P, H = 3, 64, 5
    sizes = np.random.RandomState(1).randint(4, 60, S)
    A, h, sz = bench_pallas_spmm.mk(S, P, H, sizes)
    jA, jh, jsz = jbench_pallas_spmm.mk(S, P, H, sizes, jnp.float32)
    assert np.array_equal(A, np.asarray(jA)) and np.array_equal(
        h, np.asarray(jh)) and np.array_equal(sz, np.asarray(jsz))
    src, dst, mask = bench_pallas_spmm.edges_of(A)
    assert np.array_equal(spmm.densify(
        *(torch.from_numpy(x) for x in (src, dst, mask)), S, P).numpy(), A)


def test_synth_packed_matches_jax():
    args = (3, 32, 2, 100, 64, 3, 200)
    mine = bench_transfer.synth_packed(*args, S_spt=9, S_qry=12, n_feat=50,
                                       rng=np.random.RandomState(0))
    theirs = jbench_transfer.synth_packed(*args, S_spt=9, S_qry=12,
                                          n_feat=50,
                                          rng=np.random.RandomState(0))
    for sg, jsg in zip(mine, theirs):
        assert sg._fields == jsg._fields
        for a, b in zip(sg, jsg):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_powerlaw_graph_matches_jax():
    for a, b in zip(bench_edges.powerlaw_graph(4096, 8),
                    jbench_edges.powerlaw_graph(4096, 8)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --- the paths the scripts time, against the JAX package's -------------------

@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_aggregations_match_jax(tag):
    """On one tiny bucket: dense (torch.bmm; JAX aggregate_dense), the
    sized path's plain version (JAX sized_reference), and in float32 the
    segment-sum and ELL paths (JAX aggregate, aggregate_ell), each forward
    and transposed."""
    P, B, E, H = 32, 3, 600, 7
    A, h, sizes, src, dst, mask = bench_kernels.synth_bucket(
        P, B, E, H, 0.6, np.random.RandomState(5))
    V = B * P
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[tag]
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[tag]
    At, ht = torch.from_numpy(A).to(tdt), torch.from_numpy(h).to(tdt)
    Aj, hj = jnp.asarray(A, jdt), jnp.asarray(h, jdt)
    AjT = jnp.swapaxes(Aj, 1, 2)

    def close(got, want):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), **TOLS[tag])

    close(spmm.aggregate_dense(At, ht), jspmm.aggregate_dense(Aj, hj))
    close(torch.bmm(At.float().mT, ht.float()),
          jspmm.aggregate_dense(AjT, hj))
    graph = sp.sized_graph(*(torch.from_numpy(x) for x in (src, dst, mask)),
                           B, P)
    close(sp.sized_plain(*graph.csr("fwd"), ht),
          sized_reference(Aj, hj, jnp.asarray(sizes)))
    close(sp.sized_plain(*graph.csr("bwd"), ht),
          sized_reference(AjT, hj, jnp.asarray(sizes)))
    if tag == "bf16":
        return
    hf = h.reshape(V, H)
    live = mask > 0
    for s, d in ((src, dst), (dst, src)):         # forward, transposed
        order = np.argsort(d, kind="stable")      # JAX: indices sorted
        s, d, m = s[order], d[order], mask[order]
        close(spmm.aggregate(torch.from_numpy(hf), torch.from_numpy(s),
                             torch.from_numpy(d), torch.from_numpy(m), V),
              jspmm.aggregate(jnp.asarray(hf), jnp.asarray(s),
                              jnp.asarray(d), jnp.asarray(m), V))
        ell = spmm.build_ell(s[live[order]], d[live[order]], V, row_cap=16)
        jell = jspmm.build_ell(s[live[order]], d[live[order]], V,
                               row_cap=16)
        assert all(np.array_equal(a, b) for a, b in zip(ell, jell))
        close(spmm.aggregate_ell(torch.from_numpy(hf),
                                 *(torch.from_numpy(x) for x in ell), V),
              jspmm.aggregate_ell(jnp.asarray(hf),
                                  *(jnp.asarray(x) for x in jell), V))


def _clamped(batch):
    """The batch with every edge source clamped into its destination's bin,
    as the port's densify, sized_graph and window codec read it: the
    function both packages compute on such a batch (JAX's densify would
    wrap or drop a source outside the bin instead)."""
    def one(sg):
        P = sg.node_gid.shape[-1]
        start = sg.edge_dst // P * P
        src = (start + np.clip(sg.edge_src - start, 0, P - 1)).astype(
            np.int32)
        return JSubgraphSet(*sg._replace(edge_src=src))
    return JTaskBatch(spt=one(batch.spt), qry=one(batch.qry))


@pytest.mark.parametrize("agg", ["sized", "dense"])
def test_transfer_steps_match_each_other_and_jax(agg):
    """bench_transfer's compact pool step and stream step give the same
    meta_loss from the same theta, and it equals the JAX MetaLearner's
    train_step on the same batch from the same params, at tiny widths."""
    T, n_feat, feat_dim, hidden, steps = 2, 60, 6, 8, 2
    rng = np.random.RandomState(0)
    learner = bench_transfer.make_learner(feat_dim, hidden, steps, agg,
                                          "cpu", n_feat, rng)
    batch = bench_transfer.synth_packed(T, 32, 2, 120, 32, 3, 240, S_spt=9,
                                        S_qry=12, n_feat=n_feat, rng=rng)
    pool, stream = bench_transfer.pool_and_stream_losses(learner, batch)
    assert math.isfinite(pool) and pool == stream

    spec = learner.layer_spec
    j = jmaml.MetaLearner(spec, 3, update_lr=0.01, meta_lr=1e-3,
                          update_step=steps, update_step_test=2 * steps,
                          track_curve=False)
    j.params = tuple(jnp.asarray(p.detach().numpy()) for p in learner.params)
    j.opt_state = j.tx.init(j.params)
    j.set_features(np.random.RandomState(0).randn(n_feat, feat_dim)
                   .astype(np.float32))
    want = float(j.train_step(_clamped(batch))["meta_loss"])
    assert math.isclose(pool, want, rel_tol=1e-5), (pool, want)


# --- each script's main() on the CPU -----------------------------------------

@pytest.fixture
def records(tmp_path):
    """Runs of record with tiny buckets, for bench_kernels."""
    d = tmp_path / "parity"
    d.mkdir()
    for r in bench_kernels.FEAT_HID:
        (d / f"{r}.json").write_text(json.dumps({
            "buckets": dict(P_spt=32, B_spt=2, E_spt=200, P_qry=64, B_qry=2,
                            E_qry=400), "mean_bin_fill": 0.6}))
    return d


def test_bench_kernels_main_writes_its_json(records, tmp_path):
    out = tmp_path / "kernels.json"
    res = bench_kernels.main(["--device", "cpu", "--iters", "1", "--tasks",
                              "2", "--recipes", "arxiv", "tree_of_life",
                              "--parity_dir", str(records), "--out",
                              str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert list(res["buckets"]) == ["arxiv.spt", "arxiv.qry",
                                    "tree_of_life.spt", "tree_of_life.qry"]
    row = res["buckets"]["arxiv.qry"]
    assert (row["S"], row["H"], row["P"]) == (4, 256, 64)
    for tag in ("f32", "bf16"):
        for p in ("dense", "sized"):
            for k in ("pre", "fwd", "T"):
                assert row[f"{p}_{tag}_{k}"] > 0
        assert row[f"sized_{tag}_fwd_bound_by"] in ("bytes", "operations")
        assert row[f"winner_{tag}_fwd"] in ("dense", "sized", "segment",
                                            "ell")
    assert row["segment_f32_fwd"] > 0 and row["ell_f32_fwd"] > 0
    assert row["bmm_bf16_fwd"] > 0 and row["dense_f32_fwd_b2b"] is None
    assert max(row["max_abs_err"].values()) < 0.05
    # the buckets as a bf16 run launches them: H = hidden, both ways
    main = res["main_path_bf16"]
    assert list(main) == list(res["buckets"])
    row = main["tree_of_life.spt"]
    assert (row["S"], row["H"], row["P"]) == (4, 256, 32)
    assert row["launches_per_meta_step"] == \
        bench_kernels.launches_per_meta_step(10, 1, 256)["spt"]
    for d in ("fwd", "T"):
        assert row[f"sized_{d}"] > 0 and row[f"bmm_{d}"] > 0
        assert row[f"bound_by_{d}"] in ("bytes", "operations")
        assert (row[f"sparse_{d}"] or 0) > 0 or row[f"sparse_{d}_refused"]
    ab = bench_kernels.main(["--device", "cpu", "--iters", "1", "--tasks",
                             "1", "--parity_dir", str(records),
                             "--global-b-ab", "--out", str(out)])
    assert ab["buckets"] == res["buckets"]
    assert ab["global_b_ab"]["speedup_ceiling"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_densify_serial_is_densify_bit_for_bit(dtype):
    """The old scatter (`densify_serial`, the yardstick the script times)
    and `densify` give the same adjacency, pads and duplicates included."""
    rng = np.random.RandomState(3)
    A, _, _, src, dst, mask = bench_kernels.synth_bucket(
        32, 6, 900, 4, 0.6, rng)
    args = [torch.from_numpy(a) for a in (src, dst, mask)]
    got = spmm.densify(*args, 6, 32, dtype=dtype)
    assert bench_kernels.same_bits(
        got, bench_kernels.densify_serial(*args, 6, 32, dtype=dtype))
    np.testing.assert_array_equal(got.float().numpy(), A)
    assert not bench_kernels.same_bits(got, got.to(torch.float64)
                                       .to(dtype).add(1))


@pytest.mark.parametrize("track", [True, False])
@pytest.mark.parametrize("K", [1, 3])
def test_calls_per_meta_step_counts_the_code(K, track):
    """One meta-step's aggregation calls, tallied by count_aggregation on
    a two-layer model whose layer 1 aggregates first (feat 16 < hidden
    32): layer 1 makes the forwards only, layer 2 the forwards and the
    transposes, both sets together, as `calls_per_meta_step` counts."""
    store, ds = synthetic_disjoint(
        num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=16,
        num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=4, h=2,
        sample_nodes=64, seed=3)
    spec = build_model_config(Config(hidden_dim=32), 16, 3)
    ml = MetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3, update_step=K,
                     update_step_test=1, seed=5, agg="sized", device="cpu",
                     track_curve=track)
    ml.set_features(store.features)
    with spmm.count_aggregation() as work:
        ml.train_step(next(ds["train"].batches(2, shuffle=False)))
    calls = bench_kernels.calls_per_meta_step(K, track)
    widths = [H for _, H in work.edges]
    assert widths.count(16) == calls["fwd"]
    assert widths.count(32) == calls["fwd"] + calls["T"]
    assert calls["pre"] == 2


@pytest.mark.parametrize("feat, track", [(16, True), (48, True),
                                         (16, False)])
def test_launches_per_meta_step_counts_a_bf16_step(monkeypatch, feat, track):
    """Every packed launch of one bf16 meta-step, recorded by set (its
    rows), dtype, width and direction, against `launches_per_meta_step`:
    layer 1 makes float32 forwards at feat where it aggregates first
    (feat 16 < hidden 32) and bf16 launches both ways at hidden where it
    projects first (feat 48); layer 2 bf16 both ways."""
    K = 2
    store, ds = synthetic_disjoint(
        num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=feat,
        num_classes=9, n_way=3, k_spt=3, k_qry=20, batchsz=4, h=2,
        sample_nodes=64, seed=3)
    spec = build_model_config(Config(hidden_dim=32), feat, 3)
    ml = MetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3, update_step=K,
                     update_step_test=1, seed=5, agg="sized", device="cpu",
                     track_curve=track, compute_dtype=torch.bfloat16)
    ml.set_features(store.features)
    batch = next(ds["train"].batches(2, shuffle=False))
    # each set runs repacked, T bins of its largest live count
    set_of = {2 * repack.bin_rows(repack.live_counts(
        getattr(batch, s).bin_fill)): s for s in ("spt", "qry")}
    assert len(set_of) == 2               # the sets' rows tell them apart
    seen = {"spt": {}, "qry": {}}
    launch = sp.launch

    def counted(direction, graph, x):
        n = seen[set_of[x.shape[-3] * x.shape[-2]]].setdefault(
            f"{str(x.dtype)[6:]} {x.shape[-1]}", {"fwd": 0, "T": 0})
        n["fwd" if direction == "fwd" else "T"] += 1
        return launch(direction, graph, x)
    monkeypatch.setattr(sp, "launch", counted)
    ml.train_step(batch)
    assert seen == bench_kernels.launches_per_meta_step(K, feat, 32, 2,
                                                        track)


def test_crossing_interpolates_in_log_log():
    assert bench_kernels.crossing([(1, 0.5), (2, 0.8), (4, 1.25)]) == \
        pytest.approx(2 ** 1.5)
    assert bench_kernels.crossing([(1, 0.5), (2, 0.6)]) is None
    assert bench_kernels.crossing([(1, 1.5), (2, 2.0)]) is None


def test_crossover_sweep_main_writes_its_json(monkeypatch, tmp_path):
    """--crossover at a tiny grid on the CPU: every point's calls held
    against the other path and timed, step_ms of each path from the
    counted calls, and a crossover entry per (dtype, P, H, fill)."""
    for k, v in dict(SWEEP_P=(16, 32), SWEEP_H=(1, 8), SWEEP_EDGES=(1, 2),
                     SWEEP_FILLS=(0.5,), SWEEP_BINS=3).items():
        monkeypatch.setattr(bench_kernels, k, v)
    out = tmp_path / "crossover.json"
    res = bench_kernels.main(["--device", "cpu", "--iters", "1",
                              "--crossover", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["calls"] == {"pre": 2, "fwd": 22, "T": 12}
    assert len(res["rows"]) == 2 * 1 * 2 * 2
    for row in res["rows"]:
        assert row["nnz"] == row["edges_per_slot"] * 3 * row["P"]
        assert row["E"] == int(1.5 * row["nnz"])
        for r in row["by_H"].values():
            for p in ("dense", "sized"):
                assert r[f"{p}_step_ms"] == pytest.approx(
                    2 * row[f"{p}_pre"] + 22 * r[f"{p}_fwd"]
                    + 12 * r[f"{p}_T"])
            assert r["sized_over_dense"] == pytest.approx(
                r["sized_step_ms"] / r["dense_step_ms"])
    assert len(res["crossover"]) == 2 * 2 * 2 * 1
    for c in res["crossover"].values():
        assert (c["edges_per_slot"] is None) != (
            c["faster_everywhere"] is None)


def _tiny_record(name):
    return {"buckets": {"P_spt": 128, "B_spt": 2, "E_spt": 1536,
                        "P_qry": 128, "B_qry": 3, "E_qry": 2560},
            "mean_bin_fill": 0.6, "agg": "dense", "tasks_per_s": 100.0,
            "edges_per_s": 250_000.0,
            "preset_overrides": {"device_task_pool": True}}


def test_bench_agg_main_writes_its_json(monkeypatch, tmp_path):
    """bench_agg cut: two shapes at hidden 8, one inner step, records at
    P 128, one meta-step a run; dense and sized in turns, what auto picks
    on the card and on the CPU, and two synthetic geometries at half and
    twice the crossover, where the card's rule picks sized, then dense."""
    cut = {n: dict(bench.SHAPES[n], hidden=8, task_num=2, update_step=1)
           for n in ("firstmm_db", "tree_of_life")}
    monkeypatch.setattr(bench, "SHAPES", cut)
    monkeypatch.setattr(bench, "POOL", 3)
    monkeypatch.setattr(bench, "_load_parity", _tiny_record)
    monkeypatch.setattr(bench_agg, "SYNTH_POOL", 3)
    out = tmp_path / "agg.json"
    res = bench_agg.main(["--device", "cpu", "--steps", "1", "--sweep",
                          str(tmp_path / "none.json"), "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    rows = res["geometries"]
    assert list(rows) == ["firstmm_db", "tree_of_life",
                          "tree_of_life@0.5x_crossover",
                          "tree_of_life@2x_crossover"]
    assert res["sweep_crossover"] is None
    for key, r in rows.items():
        assert [len(r["runs"][a]) for a in ("dense", "sized")] == [2, 2]
        assert r["auto_cpu"] == "dense" and r["H"] == 8
        assert r["faster"] in ("dense", "sized")
        assert all(x["tasks_per_s"] > 0 for a in r["runs"].values()
                   for x in a)
    assert rows["tree_of_life"]["auto_card"] == "sized"
    assert rows["tree_of_life"]["dtype"] == "bfloat16"
    synth = [rows[f"tree_of_life@{f}x_crossover"] for f in ("0.5", "2")]
    assert [r["auto_card"] for r in synth] == ["sized", "dense"]
    assert [r["dtype"] for r in synth] == ["float32", "float32"]
    assert synth[1]["edges_per_slot"] == pytest.approx(
        2 * res["synthetic_crossover"], rel=0.01)


def test_bench_pallas_spmm_main_writes_its_json(tmp_path):
    out = tmp_path / "pallas.json"
    res = bench_pallas_spmm.main(["--device", "cpu", "--shape", "3", "128",
                                  "8", "--iters", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert res["f32"]["fwd_err"] < 1e-4 and res["f32"]["bwd_err"] < 1e-3
    for tag in ("f32", "bf16"):
        for k in ("dense_ms", "sized_ms", "grad_dense_ms", "grad_sized_ms",
                  "sized_bound_ms", "dense_bound_ms"):
            assert res[tag][k] > 0


def test_bench_transfer_main_writes_its_json(tmp_path):
    out = tmp_path / "transfer.json"
    res = bench_transfer.main([
        "--device", "cpu", "--tasks", "2", "--reps", "1", "--buckets", "32",
        "2", "100", "32", "3", "200", "--n_feat", "60", "--feat_dim", "6",
        "--hidden", "8", "--update_step", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    for k in ("pack_s", "transfer_s", "transfer_pageable_s", "encode_s",
              "transfer_window_s", "dispatch_s", "step_pool_s",
              "step_stream_s", "pool_tasks_per_s", "stream_tasks_per_s",
              "wire_mb", "copied_mb", "window_mb"):
        assert res[k] > 0, k
    assert res["transfer_pinned_s"] is None and res["pin_s"] is None
    assert res["copied_mb"] > res["wire_mb"] > res["window_mb"]
    assert res["meta_loss_pool"] == res["meta_loss_stream"]


def test_bench_edges_main_writes_its_json(tmp_path):
    out = tmp_path / "edges.json"
    res = bench_edges.main(["10", "4", "--device", "cpu", "--hidden", "8",
                            "--iters", "1", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    assert (res["V"], res["E"]) == (1024, 4096) and res["split_rows"] > 0
    for tag in ("f32", "bf16"):
        for name in bench_edges.PATHS:
            r = res[f"{name}_{tag}"]
            assert r["fwd_edges_per_s"] > 0 and r["fb_edges_per_s"] > 0
            assert r["fb_bound_ms"] > r["fwd_bound_ms"] > 0
        assert res[f"csr_gather_{tag}"]["vs"] == "segment"


def test_bench_edgepart_main_reports_edges_per_s(tmp_path):
    data = tmp_path / "tree_of_life"
    replicas.make_tree_of_life(str(data), n_graphs=2)
    out = tmp_path / "edgepart.json"
    res = bench_edgepart.main(["--device", "cpu", "--data", str(data),
                               "--graphs", "5", "--steps", "1",
                               "--task_num", "2", "--out", str(out)])
    assert json.loads(out.read_text()) == json.loads(json.dumps(res))
    graphs = bench_edgepart.load_prefix(str(data / "graphs.npz"), 5)
    assert res["graphs"] == len(graphs) == 2
    assert res["edges"] == sum(g.num_edges for g in graphs)
    assert res["nodes"] == sum(g.num_nodes for g in graphs)
    assert res["metric"] == "edgepart_fullgraph_edges_per_s"
    assert math.isclose(res["value"], res["tasks_per_s"] * res["edges"])
    assert math.isclose(res["tasks_per_s"], 2 / res["step_s"])
    assert math.isfinite(res["meta_loss"])


def test_bench_edgepart_without_a_replica_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="data.replicas tree_of_life"):
        bench_edgepart.main(["--device", "cpu", "--data",
                             str(tmp_path / "nowhere"), "--out",
                             str(tmp_path / "x.json")])


@pytest.mark.parametrize("module", [bench_kernels, bench_pallas_spmm,
                                    bench_transfer, bench_edges,
                                    bench_edgepart, bench_agg])
def test_scripts_raise_without_cuda(module, tmp_path):
    """With no --device, a script runs on the card; without one it raises
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(["--out", str(tmp_path / "x.json")])


# --- utils/cardtime.py -------------------------------------------------------

def test_cardtime_bounds():
    # the gather: 4-byte rows read and written, int32 CSR; chip_smoke's
    # formula, unchanged by the move
    ms, by, nbytes = cardtime.gather_bound(1000, 256, 100, 50)
    assert nbytes == 4.0 * (100 * 256 + 50 * 256) + 4.0 * (51 + 1000)
    assert by == "bytes" and math.isclose(ms, 1e3 * nbytes / 3.35e12)
    ms2, _, nbytes2 = cardtime.gather_bound(1000, 256, 100, 50, itemsize=2)
    assert nbytes2 < nbytes and ms2 < ms
    ms, by, _ = cardtime.gather_bound(10**9, 256, 10, 10)
    assert by == "operations"
    assert math.isclose(ms, 1e3 * 2.0 * 10**9 * 256 / 67e12)
    # the dense product: float32 at 67 TFLOP/s, bf16 on the tensor cores
    ms, by, nbytes = cardtime.dense_bound(1184, 1024, 256, torch.float32)
    assert by == "operations"
    assert math.isclose(ms, 1e3 * 2.0 * 1184 * 1024**2 * 256 / 67e12)
    assert nbytes == 4 * (1184 * 1024**2 + 2.0 * 1184 * 1024 * 256)
    ms, by, _ = cardtime.dense_bound(1184, 1024, 256, torch.bfloat16)
    assert by == "bytes" and math.isclose(
        ms, 1e3 * 2 * (1184 * 1024**2 + 2.0 * 1184 * 1024 * 256) / 3.35e12)
    assert cardtime.device_ms(lambda: None, "cpu", iters=2) >= 0


def test_rounding_bound_holds_for_two_orders():
    """Two sums of each CSR row, in opposite orders, lie within the bound
    of each other and of the exact (float64) sum, in float32 and bf16."""
    rng = np.random.RandomState(0)
    ptr = [0, 0, 1, 40, 300]
    row_ptr = torch.tensor(ptr, dtype=torch.int32)
    col = rng.randint(0, 50, 300).astype(np.int32)
    rev = np.concatenate([col[a:b][::-1] for a, b in zip(ptr, ptr[1:])])
    x = rng.randn(50, 4).astype(np.float32)
    for dtype, unit in ((torch.float32, 2.0**-24), (torch.bfloat16, 2.0**-8)):
        xd = torch.from_numpy(x).to(dtype)
        xs = xd.double().numpy()
        exact = np.stack([xs[col[a:b]].sum(0) for a, b in zip(ptr, ptr[1:])])
        bound = cardtime.rounding_bound(row_ptr, torch.from_numpy(col), xd,
                                        unit).numpy()
        assert (bound[:2] == 0).all() and (bound[2:] > 0).all()
        one = sp.csr_plain(row_ptr, torch.from_numpy(col), xd).double()
        other = sp.csr_plain(row_ptr, torch.from_numpy(rev), xd).double()
        assert (np.abs(one.numpy() - other.numpy()) <= bound).all()
        assert (np.abs(one.numpy() - exact) <= bound).all()


def test_card_crossover_is_the_committed_sweeps():
    """data/pipeline.py's CARD_CROSSOVER is `crossover_table` of the sweep
    committed in measure_torch/bench_crossover.json, number for number."""
    from gmeta_tpu_torch.data.pipeline import CARD_CROSSOVER
    sweep = json.loads((ROOT / "measure_torch" / "bench_crossover.json")
                       .read_text())
    assert bench_kernels.crossover_table(sweep) == CARD_CROSSOVER
    assert sweep["kind"] == "NVIDIA H100 80GB HBM3"
    assert sweep["calls"] == bench_kernels.calls_per_meta_step(10)
