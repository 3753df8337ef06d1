"""Driver entry points of the port: one task's step with example
arguments, and a dry run over several ranks.

Counterpart of __graft_entry__.py.

- `entry(device=None)` returns `(fn, (params, task, feats))`: `fn` is a
  plain function of tensors on the device, ProtoMAML's query step on the
  flagship model (the GCN over a packed subgraph batch) for one task: the
  support forward, the prototypes, then the query loss and accuracy. It
  can be handed to `torch.compile`; it is not compiled here.
- `dryrun_multichip(n, device=None)` starts n ranks (processes, through
  parallel/launch.spawn_ranks) that run on tiny shapes: one task
  data-parallel meta-step (`MetaLearner(mesh=)`), the edge-partitioned
  full-graph embedding with the `all_gather` and the `boundary` halo,
  which must agree to atol 1e-4, and one `EdgePartMetaTrainer.train_step`
  and `finetune_batch` on a (task, edge) mesh of (2, n // 2) ranks, or
  (1, n) for an odd n (a mesh covers every rank of its world; the JAX
  package leaves the odd device out instead). Ranks that each have a card
  meet over NCCL; ranks that share a card, or run on the CPU, over gloo.
  Each rank checks its results, reports them with the kernel launches it
  made and the JAX modules it loaded (none), and the caller checks that
  the ranks agree.

    python -m gmeta_tpu_torch.entry [--device cuda|cpu] [--ranks N]

runs `entry()`'s function once and `dryrun_multichip(N)` (N defaults to
the number of cards), as `python __graft_entry__.py` does. Both run on
the card unless the caller names the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "gmeta_tpu")


def _tiny_setup(batchsz: int, seed: int = 0):
    from gmeta_tpu_torch.config import Config, build_model_config
    from gmeta_tpu_torch.data.synthetic import synthetic_disjoint

    store, ds = synthetic_disjoint(
        num_graphs=1, nodes_per_graph=200, avg_degree=6, feat_dim=16,
        num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=batchsz,
        h=2, sample_nodes=64, seed=seed)
    cfg = Config(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=32)
    spec = build_model_config(cfg, store.feat_dim, cfg.n_way)
    return store, ds, cfg, spec


def entry(device=None):
    """(fn, example_args): ProtoMAML's query step on one task, its
    arguments on `device` (the card unless the caller names another)."""
    from gmeta_tpu_torch.meta.maml import batch_to
    from gmeta_tpu_torch.meta.protonet import proto_loss_qry, proto_loss_spt
    from gmeta_tpu_torch.models.gcn import forward, init_params
    from gmeta_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    store, ds, cfg, spec = _tiny_setup(batchsz=2)
    params = tuple(p.to(device) for p in init_params(
        torch.Generator().manual_seed(0), spec))
    # one task, kept with its task axis of length 1
    task = batch_to(next(ds["train"].batches(1, shuffle=False)), device)
    feats = torch.as_tensor(np.asarray(store.features, np.float32),
                            device=device)

    def fn(params, task, feats):
        spt_logits = forward(params, task.spt, feats, spec)
        _, _, protos = proto_loss_spt(spt_logits, task.spt.labels, cfg.n_way)
        qry_logits = forward(params, task.qry, feats, spec)
        loss, acc = proto_loss_qry(qry_logits, task.qry.labels, protos)
        return loss[0], acc[0]

    return fn, (params, task, feats)


# ---- the dry run over ranks ---------------------------------------------------

def _rank(workdir: str, device: str, backend: str) -> None:
    """One rank of `dryrun_multichip`: its results into
    <workdir>/rank<r>.npz."""
    import torch.distributed as dist

    from gmeta_tpu_torch.meta.maml import MetaLearner
    from gmeta_tpu_torch.models.gcn import init_params
    from gmeta_tpu_torch.ops import sized_spmm as sp
    from gmeta_tpu_torch.parallel.edgepart import full_graph_embed
    from gmeta_tpu_torch.parallel.edgepart_train import (EdgePartMetaTrainer,
                                                         EdgePartTask)
    from gmeta_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from gmeta_tpu_torch.utils.device import resolve_device
    from gmeta_tpu_torch.utils.metrics import counted

    if backend == "nccl":             # a card per rank
        device = f"cuda:{os.environ['LOCAL_RANK']}"
    device = resolve_device(device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(backend, device)
    n = dist.get_world_size()
    rank = dist.get_rank()
    out, launched = {}, counted()
    try:
        # one task data-parallel meta-step over all n ranks
        store, ds, cfg, spec = _tiny_setup(batchsz=max(n, 2))
        ml = MetaLearner(spec, cfg.n_way, update_lr=0.05, meta_lr=1e-3,
                         update_step=2, update_step_test=2, seed=0,
                         device=device, mesh=make_mesh(task=n, device=device))
        ml.set_features(store.features)
        m = ml.train_step(next(ds["train"].batches(n, shuffle=False)))
        accs = m["accs"].cpu().numpy()
        assert np.isfinite(m["meta_loss"].item()), m
        assert accs.shape == (3,), accs.shape
        out.update(accs=accs, meta_loss=m["meta_loss"].item())
        out.update({f"theta{i}": p.detach().cpu().numpy()
                    for i, p in enumerate(ml.params)})

        # the edge-partitioned full-graph forward over the edge axis:
        # boundary-only halo against the all_gather halo
        g = store.graphs[0]
        dims = [(store.feat_dim, 16), (16, 16)]
        p = init_params(torch.Generator().manual_seed(1),
                        [("GraphConv", d) for d in dims]
                        + [("Linear", (16, 3))])
        edge_mesh = make_mesh(task=1, edge=n, device=device)
        emb = full_graph_embed(p[:4], store.features, g, edge_mesh, dims)
        emb_b = full_graph_embed(p[:4], store.features, g, edge_mesh, dims,
                                 halo="boundary")
        emb, emb_b = emb.cpu().numpy(), emb_b.cpu().numpy()
        assert np.isfinite(emb).all()
        assert emb.shape == (g.num_nodes, 16), emb.shape
        assert np.allclose(emb, emb_b, atol=1e-4), np.abs(emb - emb_b).max()
        out.update(embed=emb, embed_max_diff=float(np.abs(emb - emb_b).max()))

        # edge-partitioned meta-training: one sharded ProtoMAML step and
        # the sharded finetune on a (task, edge) mesh
        nt = 2 if n % 2 == 0 else 1
        ne = n // nt
        ep = EdgePartMetaTrainer(dims, (16, 3), 3, g=g, feats=store.features,
                                 mesh=make_mesh(task=nt, edge=ne,
                                                device=device),
                                 update_lr=0.05, meta_lr=1e-3,
                                 update_step=2, seed=1)
        rng = np.random.RandomState(0)
        T, S = 2 * nt, 6
        c = rng.randint(0, g.num_nodes, size=(T, S, 1)).astype(np.int32)
        y = np.tile(np.arange(3), (T, 2)).astype(np.int32)
        task = EdgePartTask(np.concatenate([c, c], 2), y,
                            np.concatenate([c, c], 2), y)
        me = ep.train_step(task)
        assert np.isfinite(me["meta_loss"].item()), me
        curves = ep.finetune_batch(task)
        assert curves.shape == (T, ep.update_step_test + 1), curves.shape
        assert np.isfinite(curves).all()
        out.update(ep_mesh=np.array([nt, ne]),
                   ep_loss=me["meta_loss"].item(), ep_curves=curves,
                   comm_rows_per_layer=ep.comm_rows_per_layer)
        out.update({f"ep_theta{i}": p.detach().cpu().numpy()
                    for i, p in enumerate(ep.params)})
        out.update({f"launches_{k}": np.array(list(launched.of(n).values()))
                    for k, n in (("packed", sp.LAUNCHES),
                                 ("csr", sp.CSR_LAUNCHES),
                                 ("combine", sp.COMBINE_LAUNCHES))})
    finally:
        dist.destroy_process_group()
    out["loaded"] = np.array(sorted(k for k in sys.modules
                                    if k.split(".")[0] in FORBIDDEN),
                             dtype=str)
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


def rank_plan(dev: torch.device, n: int, cards: int):
    """(the device each rank is given, the backend) of n ranks on `dev`
    with `cards` CUDA devices: a card per rank over NCCL where there are
    enough (each rank takes cuda:LOCAL_RANK), else every rank on the one
    card `dev` names (cuda:0 for a bare "cuda") or on the CPU, over
    gloo."""
    if dev.type == "cuda" and n <= cards:
        return "cuda", "nccl"
    if dev.type == "cuda":
        return f"cuda:{dev.index or 0}", "gloo"
    return str(dev), "gloo"


def dryrun_multichip(n: int, device=None, timeout: float = 600.0) -> dict:
    """The dry run of the module docstring over n ranks; raises if a rank
    fails or the ranks disagree, else returns a summary."""
    from gmeta_tpu_torch.parallel.launch import spawn_ranks
    from gmeta_tpu_torch.utils.device import resolve_device

    rank_device, backend = rank_plan(resolve_device(device), n,
                                     torch.cuda.device_count())
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    with tempfile.TemporaryDirectory() as work:
        spawn_ranks([sys.executable, "-m", "gmeta_tpu_torch.entry", "--rank",
                     work, rank_device, backend], n, timeout, env=env,
                    cwd=ROOT)
        outs = [dict(np.load(os.path.join(work, f"rank{r}.npz")))
                for r in range(n)]
    # every rank ends each step with the same theta and the same embedding
    for o in outs[1:]:
        for k in outs[0]:
            if k.startswith(("theta", "ep_theta")) or k == "embed":
                np.testing.assert_allclose(o[k], outs[0][k], rtol=1e-5,
                                           atol=1e-6, err_msg=k)
    o = outs[0]
    summary = {
        "ranks": n, "backend": backend, "device": rank_device,
        "accs": o["accs"].tolist(), "meta_loss": float(o["meta_loss"]),
        "embed_shape": list(o["embed"].shape),
        "embed_max_diff": max(float(x["embed_max_diff"]) for x in outs),
        "edgepart_mesh": o["ep_mesh"].tolist(),
        "edgepart_loss": float(o["ep_loss"]),
        "edgepart_curves_shape": list(o["ep_curves"].shape),
        "comm_rows_per_layer": int(o["comm_rows_per_layer"]),
        "launches": {k: dict(zip(("fwd", "bwd"), np.sum(
            [x[f"launches_{k}"] for x in outs], axis=0).tolist()))
            for k in ("packed", "csr", "combine")},
        "loaded": sorted({m for x in outs for m in x["loaded"].tolist()}),
    }
    print(f"dryrun_multichip({n}): ok over {backend} on {rank_device}, "
          f"accs={np.round(o['accs'], 3)}, edge-partitioned embed "
          f"{tuple(o['embed'].shape)} (all_gather==boundary halo), "
          f"edgepart TRAIN step mesh(task={summary['edgepart_mesh'][0]},"
          f"edge={summary['edgepart_mesh'][1]}) "
          f"loss={summary['edgepart_loss']:.3f} "
          f"comm_rows/layer={summary['comm_rows_per_layer']}", flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser("gmeta_tpu_torch.entry", allow_abbrev=False)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    ap.add_argument("--ranks", type=int, default=0,
                    help="ranks of the dry run; default the number of "
                         "cards, at least 1")
    ap.add_argument("--rank", nargs=3, metavar=("WORKDIR", "DEVICE",
                                                "BACKEND"),
                    help=argparse.SUPPRESS)   # one rank of the dry run
    args = ap.parse_args(argv)
    if args.rank:
        _rank(*args.rank)
        return
    fn, ex = entry(args.device)
    print("entry:", [float(x) for x in fn(*ex)], flush=True)
    n = args.ranks or max(torch.cuda.device_count(), 1)
    dryrun_multichip(n, args.device)


if __name__ == "__main__":
    main()
