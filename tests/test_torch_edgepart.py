"""The port's edge-partitioned engine against the JAX package: the host
plans bit for bit, `full_graph_embed` with both halos on an edge axis of 4
gloo ranks against JAX's on `make_mesh(task=1, edge=4)` and the numpy
oracle, `EdgePartMetaTrainer` on a (task 2, edge 2) mesh of 4 ranks
against JAX's (2, 2) trainer and the port at world size 1 (first and
second order, node and link prediction), the finetune curves,
`EdgePartTrainer.fit` with a mid-epoch kill and resume on 2 ranks, and
`main(--mesh_edges 2)`. The ranks are processes that import no JAX
(tests/torch_rank_worker.py)."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from gmeta_tpu.config import Config as JConfig
from gmeta_tpu.data.graph import synthetic_store as j_synthetic_store
from gmeta_tpu.data.synthetic import synthetic_link_pred as j_link_pred
from gmeta_tpu.models.gcn import init_params as j_init_params
from gmeta_tpu.parallel import edgepart as jep
from gmeta_tpu.parallel.edgepart_train import EdgePartMetaTrainer as JEngine
from gmeta_tpu.parallel.mesh import make_mesh as jmake_mesh
from gmeta_tpu.run.edgepart import EdgePartTrainer as JTrainer
from gmeta_tpu.run.edgepart import episodes_to_tasks as j_episodes
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.data.graph import synthetic_store
from gmeta_tpu_torch.ops.sized_spmm import csr_plain
from gmeta_tpu_torch.parallel import edgepart as ep
from gmeta_tpu_torch.parallel.edgepart_train import (EdgePartMetaTrainer,
                                                     EdgePartTask,
                                                     overlap_shard)
from gmeta_tpu_torch.parallel.mesh import init_distributed, make_mesh
from oracle import gcn_layer
from test_torch_mesh import assert_theta_close, prepare_dataset, thetas
from torch_rank_worker import LR, META_LR, run_main, run_scenario

torch.set_num_threads(2)

LAYERS, HEAD = [(8, 16), (16, 16)], (16, 3)


def _graph():
    store, _ = synthetic_store(1, 257, 6, 8, 3, seed=5)
    return store.graphs[0], store.features


def _task(rng, V, link_pred, T=4, S=6):
    """tests/test_edgepart_train.py's tasks: random centers, balanced
    labels."""
    if link_pred:
        c_spt = rng.randint(0, V, size=(T, S, 2))
        c_qry = rng.randint(0, V, size=(T, S, 2))
    else:
        c_spt = np.repeat(rng.randint(0, V, size=(T, S, 1)), 2, axis=2)
        c_qry = np.repeat(rng.randint(0, V, size=(T, S, 1)), 2, axis=2)
    y = np.tile(np.tile(np.arange(3), S // 3 + 1)[:S], (T, 1))
    return EdgePartTask(c_spt.astype(np.int32), y.astype(np.int32),
                        c_qry.astype(np.int32), y.astype(np.int32))


# ---- the host plans ---------------------------------------------------------

@pytest.mark.parametrize("D", [1, 2, 3, 4])
def test_shard_graph_and_plans_bit_equal_jax(D):
    """V = 257 is a multiple of no D > 1; at D = 3 the last shard owns no
    node."""
    g, _ = _graph()
    jg = j_synthetic_store(1, 257, 6, 8, 3, seed=5)[0].graphs[0]
    np.testing.assert_array_equal(g.indices, jg.indices)
    sg, jsg = ep.shard_graph(g, D), jep.shard_graph(jg, D)
    for got, want in ((sg, jsg), (ep.build_halo_plan(sg, D),
                                  jep.build_halo_plan(jsg, D)),
                      (ep.build_overlap_plan(sg, D),
                       jep.build_overlap_plan(jsg, D))):
        for a, b in zip(got, want):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(a, b)
    feats = np.arange(257 * 2, dtype=np.float32).reshape(257, 2)
    np.testing.assert_array_equal(ep.pad_features(feats, sg, D),
                                  jep.pad_features(feats, jsg, D))


@pytest.mark.parametrize("D", [1, 3])
def test_shard_csr_pairs_hold_the_plans_edges(D):
    """Each shard's local and remote CSR pairs compute the plan's masked
    segment-sums, both directions."""
    g, feats = _graph()
    sg = ep.shard_graph(g, D)
    plan = ep.build_overlap_plan(sg, D)
    h0 = ep.pad_features(feats, sg, D)
    rng = np.random.RandomState(D)
    for d in range(D):
        sh = overlap_shard(sg, plan, h0, d, D, "cpu")
        np.testing.assert_array_equal(sh.h0.numpy(),
                                      h0[d * sg.Vb:(d + 1) * sg.Vb])
        for pair, src, dst, mask, n_src in (
                (sh.local, plan.local_src, plan.local_dst, plan.local_mask,
                 sg.Vb),
                (sh.remote, plan.remote_src, plan.remote_dst,
                 plan.remote_mask, D * plan.M)):
            x = rng.randn(n_src, 3).astype(np.float32)
            want = np.zeros((sg.Vb, 3), np.float32)
            np.add.at(want, dst[d], x[src[d]] * mask[d][:, None])
            got = csr_plain(pair.row_ptr, pair.col, torch.from_numpy(x))
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       atol=1e-6)
            r = rng.randn(sg.Vb, 3).astype(np.float32)
            want_t = np.zeros((n_src, 3), np.float32)
            np.add.at(want_t, src[d], r[dst[d]] * mask[d][:, None])
            got_t = csr_plain(pair.row_ptr_t, pair.col_t,
                              torch.from_numpy(r))
            np.testing.assert_allclose(got_t.numpy(), want_t, rtol=1e-6,
                                       atol=1e-6)


# ---- 4 ranks: full-graph embedding and the meta-step --------------------------

@pytest.fixture(scope="module")
def edgepart_run(tmp_path_factory):
    g, feats = _graph()
    rng = np.random.RandomState(0)
    embed = [rng.randn(8, 16).astype(np.float32) * 0.3,
             rng.randn(16).astype(np.float32) * 0.1,
             rng.randn(16, 16).astype(np.float32) * 0.3,
             rng.randn(16).astype(np.float32) * 0.1]
    inputs = {"indptr": g.indptr, "indices": g.indices, "feats": feats}
    inputs.update({f"embed_w{i}": w for i, w in enumerate(embed)})
    tasks = {}
    for lp in (False, True):
        tasks[lp] = _task(np.random.RandomState(1 + lp), g.num_nodes, lp)
        for f, a in zip(("spt_c", "spt_y", "qry_c", "qry_y"), tasks[lp]):
            inputs[f"{f}_{lp}"] = a
        spec = [("GraphConv", d) for d in LAYERS] + [("Linear", HEAD)]
        if lp:
            spec += [("LinkPred", (True,))]
        for i, p in enumerate(j_init_params(jax.random.PRNGKey(11),
                                            tuple(spec))):
            inputs[f"init_{lp}_{i}"] = np.asarray(p)
    work = tmp_path_factory.mktemp("edgepart")
    np.savez(work / "inputs.npz", **inputs)
    return run_scenario("edgepart", 4, work), embed, tasks


@pytest.fixture(scope="module")
def world1():
    """The port at world size 1, in this process."""
    assert init_distributed("gloo", "cpu")
    yield make_mesh(1, 1)
    dist.destroy_process_group()


@pytest.mark.parametrize("halo", ["all_gather", "boundary"])
def test_full_graph_embed_matches_jax_and_the_oracle(edgepart_run, halo):
    outs, embed, _ = edgepart_run
    g, feats = _graph()
    want = np.asarray(jep.full_graph_embed(
        [np.asarray(w) for w in embed], feats, g,
        jmake_mesh(task=1, edge=4), LAYERS, halo=halo))
    src = g.indices.astype(np.int64)
    dst = np.repeat(np.arange(g.num_nodes), np.diff(g.indptr))
    h = feats.astype(np.float64)
    for i in range(2):
        h = gcn_layer(h, src, dst, g.num_nodes, embed[2 * i],
                      embed[2 * i + 1])
    for out in outs:
        got = out[f"embed_{halo}"]
        assert got.shape == (257, 16)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got, h, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("first_order", [True, False])
@pytest.mark.parametrize("link_pred", [False, True])
def test_meta_step_matches_jax_and_world_one(edgepart_run, world1,
                                             link_pred, first_order):
    outs, _, tasks = edgepart_run
    g, feats = _graph()
    task = tasks[link_pred]
    kw = dict(link_pred=link_pred, update_lr=LR, meta_lr=META_LR,
              update_step=3, update_step_test=4, first_order=first_order,
              seed=11)
    j = JEngine(LAYERS, HEAD, 3, g=g, feats=feats,
                mesh=jmake_mesh(task=2, edge=2), **kw)
    jstart = [np.asarray(p) for p in j.params]
    mj = j.train_step(task)
    one = EdgePartMetaTrainer(LAYERS, HEAD, 3, g=g, feats=feats, mesh=world1,
                              **kw)
    one.set_params(params_from_jax(jstart))
    m1 = one.train_step(task)
    key = f"{link_pred}_{first_order}"
    for out in outs:
        for m in (mj, m1):
            np.testing.assert_allclose(out[f"loss_{key}"],
                                       float(m["meta_loss"]), rtol=1e-5)
            np.testing.assert_allclose(out[f"acc_{key}"],
                                       float(m["qry_acc"]), atol=1e-6)
        got = thetas(out, f"theta_{key}_")
        assert_theta_close(got, [np.asarray(p) for p in j.params], 1,
                           what="vs JAX (2, 2)")
        assert_theta_close(got, [p.numpy() for p in one.params], 1,
                           what="vs world 1")
        assert out["loaded"].size == 0, out["loaded"]
    if first_order:
        want = j.finetune_batch(task)
        assert want.shape == (4, 5)
        np.testing.assert_allclose(one.finetune_batch(task), want,
                                   atol=1e-6)
        for out in outs:
            np.testing.assert_allclose(out[f"finetune_{link_pred}"], want,
                                       atol=1e-6)


# ---- 2 ranks: the trainer's protocol and the CLI ----------------------------

EP_MAIN_FLAGS = ["--n_way=3", "--k_spt=2", "--k_qry=3", "--h=2",
                 "--batchsz=8", "--eval_batchsz=4", "--hidden_dim=8",
                 "--epoch=1", "--task_num=4", "--update_step=2",
                 "--update_step_test=2", "--device=cpu", "--metrics_path="]


@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    store, datasets = j_link_pred(
        num_graphs=5, nodes_per_graph=120, avg_degree=6, feat_dim=8,
        k_spt=4, k_qry=4, batchsz=8, seed=2)
    tasks = {m: j_episodes(ds.sampler, ds.labels, store, "Shared")
             for m, ds in datasets.items()}
    cfg = JConfig(task_setup="Shared", link_pred_mode=True, n_way=2,
                  k_spt=4, k_qry=4, h=2, epoch=2, task_num=4, batchsz=8,
                  hidden_dim=16, update_step=2, update_step_test=3,
                  metrics_path="")
    jtr = JTrainer(cfg, store, tasks, 2, jmake_mesh(task=1, edge=2))
    work = tmp_path_factory.mktemp("edgepart_fit")
    np.savez(work / "inputs.npz", **{f"fit_init{i}": np.asarray(p)
                                     for i, p in enumerate(jtr.engine.params)})
    prepare_dataset(work / "ds")
    outs = run_scenario("edgepart_fit", 2, work)
    return outs, jtr.fit(), [np.asarray(p) for p in jtr.engine.params], work


def test_edgepart_fit_matches_jax(fit_run):
    outs, jres, jtheta, _ = fit_run
    for out in outs:
        assert int(out["global_step"]) == jres.global_step == 4
        assert_theta_close(thetas(out, "straight"), jtheta, 4,
                           what="fit vs JAX")
        np.testing.assert_allclose(float(out["val_max_acc"]),
                                   jres.val_max_acc, atol=1e-6)
        np.testing.assert_allclose(float(out["test_acc_final"]),
                                   jres.test_acc_final, atol=1e-6)
        comm, allgather = out["comm"]
        assert 0 < comm < allgather


def test_edgepart_fit_kill_and_resume(fit_run):
    outs = fit_run[0]
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["resumed_start"], [1, 1])
        assert int(out["resumed_step"]) == 4
        for a, b in zip(thetas(out, "resumed"), thetas(out, "straight")):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert int(out["saves"]) == (6 if rank == 0 else 0)


def test_main_mesh_edges_equals_world_one(fit_run, world1):
    outs, _, _, work = fit_run
    result, tr = run_main([f"--data_dir={work / 'ds'}", "--mesh_edges=1"]
                          + EP_MAIN_FLAGS)
    assert dist.is_initialized()          # main kept the caller's group
    theta = [p.numpy() for p in tr.engine.params]
    for out in outs:
        assert int(out["main_step"]) == result.global_step == 2
        assert_theta_close(thetas(out, "main"), theta, 2,
                           what="main 2 ranks vs 1")
