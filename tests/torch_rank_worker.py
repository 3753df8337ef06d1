"""One rank of the port's multi-rank CPU tests (gloo).

    python tests/torch_rank_worker.py <scenario> <workdir>

run by `gmeta_tpu_torch.parallel.launch.spawn_ranks`, which sets RANK,
WORLD_SIZE and the rendezvous. It imports neither jax nor the JAX package:
what it needs of the JAX side (initial parameters, graphs, tasks) the test
writes into <workdir>/inputs.npz, and each rank writes what it computed
into <workdir>/<scenario>_rank<r>.npz, together with the names of any
jax, optax or gmeta_tpu modules it loaded (`loaded`, expected empty).
Scenarios:
  mesh          4 ranks: collectives, rank layout, task-DP MetaLearner steps,
                the NaN guard (tests/test_torch_mesh.py)
  main_tasks    2 ranks: main(--mesh_tasks 2), straight and killed + resumed
  edgepart      4 ranks: full_graph_embed on (1, 4), EdgePartMetaTrainer on
                (2, 2) (tests/test_torch_edgepart.py)
  edgepart_fit  2 ranks: EdgePartTrainer.fit straight and killed + resumed
                on (1, 2), and main(--mesh_edges 2)
  isolation     2 ranks: a task-DP step and an edge-partitioned step
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.meta import maml
from gmeta_tpu_torch.parallel import collectives as coll
from gmeta_tpu_torch.parallel.mesh import init_distributed, make_mesh

LR, META_LR = 0.05, 1e-3
WORK = None    # the scenario's directory, set by main()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_scenario(scenario, nprocs, workdir, timeout=240.0):
    """From a test: run `scenario` on `nprocs` gloo ranks and return each
    rank's outputs as a dict of arrays."""
    from gmeta_tpu_torch.parallel.launch import spawn_ranks
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    spawn_ranks([sys.executable, os.path.abspath(__file__), scenario,
                 str(workdir)], nprocs, timeout, env=env)
    return [dict(np.load(os.path.join(workdir, f"{scenario}_rank{r}.npz")))
            for r in range(nprocs)]


class Killed(Exception):
    """Stands in for a killed process."""


def inputs():
    return np.load(os.path.join(WORK, "inputs.npz"))


def seq(arrs, prefix):
    """The arrays prefix0, prefix1, ... of an npz, in order."""
    n = sum(1 for k in arrs.files if k.startswith(prefix)
            and k[len(prefix):].isdigit())
    return [arrs[f"{prefix}{i}"] for i in range(n)]


def flat(prefix, tensors):
    return {f"{prefix}{i}": t.detach().cpu().numpy()
            for i, t in enumerate(tensors)}


def collectives_case(group, rank):
    """Forward, backward and double backward of both collectives at
    float64, on inputs the test regenerates from the same seeds."""
    out = {}
    rng = np.random.RandomState(100 + rank)
    x0, w, v = (torch.from_numpy(rng.randn(4, 3, 5)) for _ in range(3))
    for name, fn in (("ar", coll.all_reduce_sum), ("a2a", coll.all_to_all)):
        x = x0.clone().requires_grad_()
        y = fn(x, group)
        g, = torch.autograd.grad((y * y * w).sum(), x, create_graph=True)
        gg, = torch.autograd.grad((g * v).sum(), x)
        out.update({f"{name}_y": y.detach().numpy(),
                    f"{name}_g": g.detach().numpy(),
                    f"{name}_gg": gg.numpy()})
    y, wait = coll.all_to_all_start(x0, group)
    wait()
    out["a2a_async_y"] = y.numpy()
    return out


def tiny_disjoint():
    from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
    return synthetic_disjoint(
        num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=8,
        num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=8, h=2,
        sample_nodes=96, seed=3)


def learner(spec, mesh, jparams, store):
    ml = maml.MetaLearner(spec, 3, update_lr=LR, meta_lr=META_LR,
                          update_step=2, update_step_test=3, seed=0,
                          agg="sized", device="cpu", mesh=mesh)
    ml.set_params(params_from_jax(jparams))
    ml.set_features(store.features)
    return ml


def scenario_mesh(rank):
    arrs = inputs()
    out = {}
    m22 = make_mesh(task=2, edge=2)
    out.update(t=m22.t, e=m22.e)
    for name, grp in (("edge", m22.edge_group), ("task", m22.task_group)):
        onehot = torch.zeros(dist.get_world_size())
        onehot[rank] = 1.0
        out[f"{name}_members"] = coll.all_reduce_sum(onehot, grp).numpy()
    out.update(collectives_case(m22.world, rank))

    # task-DP: two meta-steps over 4 ranks from the JAX package's theta
    m4 = make_mesh(task=4)
    store, ds = tiny_disjoint()
    spec = build_model_config(Config(n_way=3, k_spt=3, k_qry=4, h=2,
                                     hidden_dim=16), store.feat_dim, 3)
    jparams = seq(arrs, "jparams")
    ml = learner(spec, m4, jparams, store)
    for k, batch in enumerate(ds["train"].batches(4, shuffle=False)):
        mt = ml.train_step(batch)
        out.update({f"loss{k}": mt["meta_loss"].numpy(),
                    f"accs{k}": mt["accs"].numpy()})
    out.update(flat("theta", ml.params))
    out["finetune"] = ml.finetune_batch(batch).numpy()

    # the NaN guard: a NaN in rank 1's features only; every rank skips
    ml = learner(spec, m4, jparams, store)
    ml.train_step(batch)
    if rank == 1:
        ml.set_features(np.full_like(store.features, np.nan))
    before = [p.detach().clone() for p in ml.params]
    count = ml.opt_state.count.clone()
    mt = ml.train_step(batch)
    out["nan_skip"] = mt["nan_skip"].numpy()
    out["nan_unchanged"] = np.array(
        all(torch.equal(a, b) for a, b in zip(before, ml.params))
        and torch.equal(count, ml.opt_state.count))
    return out


def run_main(argv):
    """main(argv) with the Trainer it built (any trainer class of
    run/train.py or run/edgepart.py)."""
    from gmeta_tpu_torch.run import edgepart, train
    seen = []
    originals = (train.Trainer, edgepart.EdgePartTrainer)

    def spy(cls):
        class Seen(cls):
            def fit(self):
                seen.append(self)
                return super().fit()
        return Seen
    train.Trainer = spy(originals[0])
    edgepart.EdgePartTrainer = spy(originals[1])
    try:
        result = train.main(argv)
    finally:
        train.Trainer, edgepart.EdgePartTrainer = originals
    return result, seen[0]


def count_saves():
    """Counts the checkpoint files this rank writes."""
    from gmeta_tpu_torch.utils import checkpoint
    calls = []
    orig = checkpoint.save

    def counting(*a, **k):
        calls.append(1)
        return orig(*a, **k)
    checkpoint.save = counting
    return calls


def kill_after(obj, name, n):
    """Make obj.name raise Killed on its (n+1)-th call."""
    orig = getattr(obj, name)
    calls = []

    def killing(*a, **k):
        if len(calls) == n:
            raise Killed()
        calls.append(1)
        return orig(*a, **k)
    setattr(obj, name, killing)
    return lambda: setattr(obj, name, orig)


def scenario_main_tasks(rank):
    data, ck = os.path.join(WORK, "ds"), os.path.join(WORK, "ck")
    argv = [f"--data_dir={data}", "--n_way=3", "--k_spt=2", "--k_qry=3",
            "--h=2", "--sample_nodes=40", "--batchsz=8", "--eval_batchsz=4",
            "--extractor=numpy", "--hidden_dim=8", "--epoch=2",
            "--task_num=4", "--update_step=2", "--update_step_test=2",
            "--agg=sized", "--device=cpu", "--mesh_tasks=2",
            f"--metrics_path={os.path.join(WORK, 'metrics.jsonl')}"]
    out = {}
    result, tr = run_main(argv)
    out.update(flat("straight", tr.learner.params))
    out["straight_step"] = result.global_step
    out["straight_val"] = result.val_max_acc
    saves = count_saves()
    ck_argv = argv + [f"--checkpoint_dir={ck}", "--checkpoint_every_steps=1"]
    restore = kill_after(maml.MetaLearner, "train_step", 3)
    try:
        run_main(ck_argv)
        raise AssertionError("the fit was not killed")
    except Killed:
        pass
    finally:
        restore()
    out["saves_killed"] = len(saves)
    result, tr = run_main(ck_argv)
    out.update(flat("resumed", tr.learner.params))
    out["resumed_start"] = np.array([tr._fit_from_epoch, tr.start_batch])
    out["resumed_step"] = result.global_step
    out["saves"] = len(saves)
    out["group_kept"] = dist.is_initialized()
    return out


def scenario_edgepart(rank):
    from gmeta_tpu_torch.data.graph import CSRGraph
    from gmeta_tpu_torch.parallel.edgepart import full_graph_embed
    from gmeta_tpu_torch.parallel.edgepart_train import (EdgePartMetaTrainer,
                                                         EdgePartTask)
    arrs = inputs()
    g = CSRGraph(arrs["indptr"], arrs["indices"])
    feats = arrs["feats"]
    out = {}
    m14 = make_mesh(task=1, edge=4)
    for halo in ("all_gather", "boundary"):
        out[f"embed_{halo}"] = full_graph_embed(
            seq(arrs, "embed_w"), feats, g, m14, [(8, 16), (16, 16)],
            halo=halo).numpy()
    m22 = make_mesh(task=2, edge=2)
    for lp in (False, True):
        task = EdgePartTask(*(arrs[f"{f}_{lp}"] for f in
                              ("spt_c", "spt_y", "qry_c", "qry_y")))
        for fo in (True, False):
            tr = EdgePartMetaTrainer(
                [(8, 16), (16, 16)], (16, 3), 3, g=g, feats=feats, mesh=m22,
                link_pred=lp, update_lr=LR, meta_lr=META_LR, update_step=3,
                update_step_test=4, first_order=fo, seed=11)
            tr.set_params(params_from_jax(seq(arrs, f"init_{lp}_")))
            mt = tr.train_step(task)
            key = f"{lp}_{fo}"
            out.update(flat(f"theta_{key}_", tr.params))
            out[f"loss_{key}"] = mt["meta_loss"].numpy()
            out[f"acc_{key}"] = mt["qry_acc"].numpy()
            if fo:
                out[f"finetune_{lp}"] = tr.finetune_batch(task)
    return out


def link_tasks():
    from gmeta_tpu_torch.data.synthetic import synthetic_link_pred
    from gmeta_tpu_torch.run.edgepart import episodes_to_tasks
    store, datasets = synthetic_link_pred(
        num_graphs=5, nodes_per_graph=120, avg_degree=6, feat_dim=8,
        k_spt=4, k_qry=4, batchsz=8, seed=2)
    tasks = {m: episodes_to_tasks(ds.sampler, ds.labels, store, "Shared")
             for m, ds in datasets.items()}
    return store, tasks


def edgepart_cfg(**kw):
    return Config(task_setup="Shared", link_pred_mode=True, n_way=2,
                  k_spt=4, k_qry=4, h=2, epoch=2, task_num=4, batchsz=8,
                  hidden_dim=16, update_step=2, update_step_test=3,
                  metrics_path="", **kw)


def scenario_edgepart_fit(rank):
    from gmeta_tpu_torch.run.edgepart import EdgePartTrainer
    arrs = inputs()
    store, tasks = link_tasks()
    mesh = make_mesh(task=1, edge=2)
    init = params_from_jax(seq(arrs, "fit_init"))
    out = {}

    def trainer(cfg):
        tr = EdgePartTrainer(cfg, store, tasks, 2, mesh)
        if tr.global_step == 0:
            tr.engine.set_params(init)
            tr.best_params = tr.engine.params
        return tr
    straight = trainer(edgepart_cfg())
    res = straight.fit()
    out.update(flat("straight", straight.engine.params))
    out.update(test_acc_final=res.test_acc_final, val_max_acc=res.val_max_acc,
               global_step=res.global_step)
    out["comm"] = np.array([straight.comm["comm_rows_per_layer"],
                            straight.comm["allgather_rows_per_layer"]])
    ck = edgepart_cfg(checkpoint_dir=os.path.join(WORK, "ck"),
                      checkpoint_every_steps=1)
    saves = count_saves()
    killed = trainer(ck)
    kill_after(killed.engine, "train_step", 3)
    try:
        killed.fit()
        raise AssertionError("the fit was not killed")
    except Killed:
        pass
    resumed = trainer(ck)
    out["resumed_start"] = np.array([resumed.start_epoch,
                                     resumed.start_batch])
    res = resumed.fit()
    out.update(flat("resumed", resumed.engine.params))
    out["resumed_step"] = res.global_step
    out["saves"] = len(saves)

    data = os.path.join(WORK, "ds")
    result, tr = run_main([
        f"--data_dir={data}", "--n_way=3", "--k_spt=2", "--k_qry=3",
        "--h=2", "--batchsz=8", "--eval_batchsz=4", "--hidden_dim=8",
        "--epoch=1", "--task_num=4", "--update_step=2",
        "--update_step_test=2", "--device=cpu", "--mesh_edges=2",
        "--metrics_path="])
    out.update(flat("main", tr.engine.params))
    out["main_step"] = result.global_step
    return out


def scenario_isolation(rank):
    from gmeta_tpu_torch.data.graph import synthetic_store
    from gmeta_tpu_torch.parallel.edgepart_train import (EdgePartMetaTrainer,
                                                         EdgePartTask)
    store, ds = tiny_disjoint()
    spec = build_model_config(Config(hidden_dim=8), store.feat_dim, 3)
    ml = maml.MetaLearner(spec, 3, update_lr=LR, meta_lr=META_LR,
                          update_step=2, update_step_test=2, agg="sized",
                          device="cpu", mesh=make_mesh(task=2))
    ml.set_features(store.features)
    ml.train_step(next(ds["train"].batches(4)))
    gstore, _ = synthetic_store(1, 100, 4, 8, 3, seed=1)
    c = np.random.RandomState(0).randint(0, 100, (2, 6, 2)).astype(np.int32)
    y = np.tile(np.arange(3, dtype=np.int32), (2, 2))
    tr = EdgePartMetaTrainer([(8, 8)], (8, 3), 3, g=gstore.graphs[0],
                             feats=gstore.features, mesh=make_mesh(1, 2),
                             update_step=2)
    m = tr.train_step(EdgePartTask(c, y, c, y))
    return {"loss": m["meta_loss"].numpy()}


def main():
    global WORK
    scenario, WORK = sys.argv[1], sys.argv[2]
    torch.set_num_threads(1)
    init_distributed("gloo", "cpu")
    rank = dist.get_rank()
    out = globals()[f"scenario_{scenario}"](rank)
    out["loaded"] = np.array(sorted(
        k for k in sys.modules
        if k.split(".")[0] in ("jax", "jaxlib", "optax", "gmeta_tpu")),
        dtype=str)
    np.savez(os.path.join(WORK, f"{scenario}_rank{rank}.npz"), **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
