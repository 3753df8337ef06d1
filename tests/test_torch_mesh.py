"""The port's task data-parallelism over torch.distributed against the JAX
package: the collectives and their autograd rules, the rank layout,
`MetaLearner(mesh=)` over 4 gloo ranks against the JAX package's
`MetaLearner(mesh=make_mesh(task=4))` on the virtual devices and against
the port without a mesh, the NaN guard across ranks, and
`main(--mesh_tasks 2)` on 2 ranks with a mid-epoch kill and resume. The
ranks are processes that import no JAX (tests/torch_rank_worker.py)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from gmeta_tpu.meta import maml as jmaml
from gmeta_tpu.parallel.mesh import make_mesh as jmake_mesh
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.data.graph import synthetic_store
from gmeta_tpu_torch.data.prepare import prepare_node_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner
from gmeta_tpu_torch.run import train as train_mod
from torch_rank_worker import LR, META_LR, run_main, run_scenario, \
    tiny_disjoint

torch.set_num_threads(2)


def assert_theta_close(got, want, steps, meta_lr=META_LR, what=""):
    """Every parameter at rtol 1e-5 (atol 1e-5 = meta_lr / 100: Adam moves
    an entry whose gradient is at the rounding level by a fraction of
    meta_lr); the head bias, whose meta-gradient is analytically zero
    (tests/test_torch_meta.py::_assert_params_close), within 2 * steps *
    meta_lr."""
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        a, b = np.asarray(a), np.asarray(b)
        if i == len(got) - 1:
            assert np.abs(a - b).max() <= 2 * steps * meta_lr * 1.001, what
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=f"{what} param {i}")


def thetas(out, prefix):
    n = sum(1 for k in out if k.startswith(prefix) and k[len(prefix):]
            .isdigit())
    return [out[f"{prefix}{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def case():
    store, ds = tiny_disjoint()
    spec = build_model_config(Config(n_way=3, k_spt=3, k_qry=4, h=2,
                                     hidden_dim=16), store.feat_dim, 3)
    jparams = [np.asarray(p) for p in
               jmaml.init_params(jax.random.PRNGKey(0), spec)]
    batches = list(ds["train"].batches(4, shuffle=False))
    return store, spec, jparams, batches


@pytest.fixture(scope="module")
def mesh_run(case, tmp_path_factory):
    work = tmp_path_factory.mktemp("mesh")
    np.savez(work / "inputs.npz",
             **{f"jparams{i}": p for i, p in enumerate(case[2])})
    return run_scenario("mesh", 4, work)


def _collective_reference(kind, rank):
    """What rank `rank` must compute, from one process: F = sum over ranks
    of each rank's loss, differentiated by ordinary autograd."""
    xs, ws, vs = [], [], []
    for r in range(4):
        rng = np.random.RandomState(100 + r)
        x, w, v = (torch.from_numpy(rng.randn(4, 3, 5)) for _ in range(3))
        xs.append(x.requires_grad_())
        ws.append(w)
        vs.append(v)
    if kind == "ar":
        total = sum(xs)
        ys = [total] * 4
    else:                       # y_r[p] = x_p[r]
        ys = [torch.stack([xs[p][r] for p in range(4)]) for r in range(4)]
    F = sum((y * y * w).sum() for y, w in zip(ys, ws))
    gs = torch.autograd.grad(F, xs, create_graph=True)
    ggs = torch.autograd.grad(sum((g * v).sum() for g, v in zip(gs, vs)),
                              xs)
    return ys[rank].detach(), gs[rank].detach(), ggs[rank]


@pytest.mark.parametrize("kind", ["ar", "a2a"])
def test_collectives_forward_backward_double_backward(mesh_run, kind):
    for rank, out in enumerate(mesh_run):
        y, g, gg = _collective_reference(kind, rank)
        np.testing.assert_allclose(out[f"{kind}_y"], y.numpy(), rtol=1e-12)
        np.testing.assert_allclose(out[f"{kind}_g"], g.numpy(), rtol=1e-12)
        np.testing.assert_allclose(out[f"{kind}_gg"], gg.numpy(),
                                   rtol=1e-12)
        if kind == "a2a":
            np.testing.assert_array_equal(out["a2a_async_y"], out["a2a_y"])


def test_rank_layout_matches_the_jax_device_grid(mesh_run):
    ids = np.vectorize(lambda d: d.id)(jmake_mesh(task=2, edge=2).devices)
    for rank, out in enumerate(mesh_run):
        (t, e), = np.argwhere(ids == rank)
        assert (int(out["t"]), int(out["e"])) == (t, e)
        np.testing.assert_array_equal(np.flatnonzero(out["edge_members"]),
                                      np.sort(ids[t]))
        np.testing.assert_array_equal(np.flatnonzero(out["task_members"]),
                                      np.sort(ids[:, e]))


def test_task_dp_steps_match_jax_and_the_unsharded_port(case, mesh_run):
    store, spec, jparams, batches = case
    args = dict(update_lr=LR, meta_lr=META_LR, update_step=2,
                update_step_test=3, seed=0, agg="sized")
    jmesh = jmake_mesh(task=4)
    j = jmaml.MetaLearner(spec, 3, mesh=jmesh, **args)
    j.params = tuple(jnp.asarray(p) for p in jparams)
    j.opt_state = j.tx.init(j.params)
    j._feats = jax.device_put(jnp.asarray(store.features, jnp.float32),
                              NamedSharding(jmesh, P()))
    t = MetaLearner(spec, 3, device="cpu", **args)
    t.set_params(params_from_jax(jparams))
    t.set_features(store.features)
    for k, batch in enumerate(batches):
        mj, mt = j.train_step(batch), t.train_step(batch)
        for out in mesh_run:
            np.testing.assert_allclose(out[f"loss{k}"], float(mj["meta_loss"]),
                                       rtol=1e-5)
            np.testing.assert_allclose(out[f"loss{k}"],
                                       mt["meta_loss"].item(), rtol=1e-5)
            np.testing.assert_allclose(out[f"accs{k}"], mt["accs"].numpy(),
                                       atol=1e-6)
    steps = len(batches)
    for out in mesh_run:
        # every rank holds the same theta, bit for bit
        for a, b in zip(thetas(out, "theta"), thetas(mesh_run[0], "theta")):
            np.testing.assert_array_equal(a, b)
        assert_theta_close(thetas(out, "theta"),
                           [np.asarray(p) for p in j.params], steps,
                           what="vs JAX")
        assert_theta_close(thetas(out, "theta"),
                           [p.detach().numpy() for p in t.params], steps,
                           what="vs unsharded")
        np.testing.assert_allclose(out["finetune"],
                                   t.finetune_batch(batches[-1]).numpy(),
                                   atol=1e-6)
        assert out["loaded"].size == 0, out["loaded"]


def test_nan_on_one_rank_makes_every_rank_skip(mesh_run):
    for out in mesh_run:
        assert int(out["nan_skip"]) == 1
        assert bool(out["nan_unchanged"])


# ---- main(--mesh_tasks) -----------------------------------------------------

MAIN_FLAGS = ["--n_way=3", "--k_spt=2", "--k_qry=3", "--h=2",
              "--sample_nodes=40", "--batchsz=8", "--eval_batchsz=4",
              "--extractor=numpy", "--hidden_dim=8", "--epoch=2",
              "--task_num=4", "--update_step=2", "--update_step_test=2",
              "--agg=sized", "--device=cpu"]


def prepare_dataset(out):
    store, labels = synthetic_store(num_graphs=2, nodes_per_graph=150,
                                    avg_degree=6, feat_dim=8, num_classes=9,
                                    seed=0, class_signal=2.0)
    feats = [store.features[store.node_offsets[g]:store.node_offsets[g + 1]]
             for g in range(2)]
    prepare_node_disjoint(str(out), store.graphs, feats, labels,
                          num_label_set=3, seed=0)


@pytest.fixture(scope="module")
def main_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("main_tasks")
    prepare_dataset(work / "ds")
    outs = run_scenario("main_tasks", 2, work)
    result, tr = run_main([f"--data_dir={work / 'ds'}"] + MAIN_FLAGS)
    return outs, result, [p.detach().numpy() for p in tr.learner.params], \
        work


def test_main_mesh_tasks_equals_unsharded_main(main_run):
    outs, result, theta, _ = main_run
    for out in outs:
        assert int(out["straight_step"]) == result.global_step == 4
        assert_theta_close(thetas(out, "straight"), theta, 4,
                           what="2 ranks vs unsharded")
        np.testing.assert_allclose(float(out["straight_val"]),
                                   result.val_max_acc, atol=1e-6)
        assert bool(out["group_kept"])     # main left the caller's group
        assert out["loaded"].size == 0, out["loaded"]


def test_main_mesh_tasks_kill_and_resume(main_run):
    """Killed at its fourth step, resumed from the mid-epoch checkpoint of
    step 3; every checkpoint written once, by rank 0."""
    outs, _, _, work = main_run
    for rank, out in enumerate(outs):
        np.testing.assert_array_equal(out["resumed_start"], [1, 1])
        assert int(out["resumed_step"]) == 4
        for a, b in zip(thetas(out, "resumed"), thetas(out, "straight")):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        # steps 1-3, the end of epoch 1; then step 4, the end of epoch 2
        assert (int(out["saves_killed"]), int(out["saves"])) == \
            ((4, 6) if rank == 0 else (0, 0))
    ckpts = sorted(f for f in os.listdir(work / "ck") if f.endswith(".pkl"))
    assert ckpts == [f"ckpt_{s:08d}.pkl" for s in (1, 2, 3, 4)]


def test_main_runs_a_world_of_one_and_ends_it(main_run):
    """--mesh_tasks 1 with no launcher: main starts a world of one on an
    in-process store, runs the same fit as without a mesh, and ends the
    group it started."""
    _, result, theta, work = main_run
    assert not dist.is_initialized()
    res1, tr1 = run_main([f"--data_dir={work / 'ds'}", "--mesh_tasks=1"]
                         + MAIN_FLAGS)
    assert not dist.is_initialized()
    assert res1 == result
    for a, b in zip(tr1.learner.params, theta):
        np.testing.assert_array_equal(a.detach().numpy(), b)


# ---- the launch model's refusals --------------------------------------------

def test_a_mesh_larger_than_the_world_says_how_to_launch(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 6"):
        train_mod.main(["--data_dir=unused", "--mesh_tasks=3",
                        "--mesh_edges=2", "--device=cpu"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("env, device, backend, match", [
    # every rank pinned to one card under NCCL
    (dict(LOCAL_WORLD_SIZE="2"), "cuda:0", None, "NCCL refuses"),
    # more ranks on the host than cards
    (dict(LOCAL_WORLD_SIZE="3"), None, "nccl", "NCCL refuses"),
    # a rank with no card of its own and no --device
    (dict(LOCAL_RANK="1", LOCAL_WORLD_SIZE="2"), None, None,
     "no card of its own"),
    (dict(), "cpu", "nccl", "needs CUDA"),
])
def test_rank_device_refusals(monkeypatch, env, device, backend, match):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises((ValueError, RuntimeError), match=match):
        train_mod.rank_device(device, backend)


def test_rank_device_defaults(monkeypatch):
    """cuda:LOCAL_RANK under NCCL, gloo on the CPU, and gloo on a shared
    card only when asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    assert train_mod.rank_device(None, None) == (torch.device("cuda:1"),
                                                 "nccl")
    assert train_mod.rank_device("cpu", None) == (torch.device("cpu"), "gloo")
    assert train_mod.rank_device("cuda:0", "gloo") == (
        torch.device("cuda:0"), "gloo")


def test_task_chunk_with_a_mesh_raises(case):
    with pytest.raises(ValueError, match="task_chunk"):
        MetaLearner(case[1], 3, update_lr=LR, meta_lr=META_LR,
                    update_step=2, update_step_test=2, task_chunk=2,
                    device="cpu", mesh=object())
