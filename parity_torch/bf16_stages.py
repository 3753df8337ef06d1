"""Stage-by-stage comparison of the port's bf16 meta-step with the JAX
package's, on the CPU.

    JAX_PLATFORMS=cpu python parity_torch/bf16_stages.py [--dtype bfloat16]
        [--out FILE]

The same numpy inputs and parameters (`convert.params_from_jax`) go
through both packages, and each stage reports the share of its entries
whose values are not equal (bit for bit, up to the sign of zero):

  (a) every GraphConv layer's activations (the `collect` hook) over the
      grid of tests/test_torch_gcn.py `test_forward_matches_jax`: node and
      link-pred, depth 1-3, hidden 4 (projects first) and 32 (aggregates
      first), dense and sized; JAX eager, as that test runs it;
  (b) the support loss and the gradient of one inner step from theta
      (gmeta_tpu/meta/maml.py:81-84, jitted and vmapped over the tasks as
      MetaLearner runs it);
  (c) the fast weights after `update_step` inner steps (maml.py:81-89 in
      a lax.scan);
  (d) the query loss and the meta-gradient (MetaLearner's meta_loss_fn,
      make_inner_loop with track_curve=False, as bench.py runs it);
  (e) theta after one meta-step (each package's MetaLearner.train_step,
      Adam from each one's own meta-gradient), and one Adam step in each
      package from JAX's meta-gradient ("same gradient": optax.adam
      compiled by XLA against the port's adam_update).

Every JAX function of (b)-(e) is compiled twice: as XLA compiles it by
default, and with xla_allow_excess_precision off ("honour"), where XLA
rounds every bf16 value the program names, as the port does.
`bias_reduction` isolates the one reduction where the two then part.

Stages (b)-(e) run on a task pool of the tissue_ppi shape of the
throughput benchmark cut as tests/test_torch_bench.py cuts it (hidden 16,
2 tasks, 2 inner steps, P = 128, the JAX seed-0 theta), once with the
dense aggregation and once with the sized one. Each stage takes the
values its own package computed at the stage before, so a share counts
what parted there or earlier.

This script is not part of the port: it imports jax and the JAX package.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))

CUT = dict(hidden=16, task_num=2, update_step=2)   # test_torch_bench.CUT
POOL = 4
LR, META_LR = 0.01, 1e-3                           # bench.run_shape's


def parted(a, b) -> np.ndarray:
    """Entries of a and b (numpy, JAX or torch; any float dtype) whose
    values differ; NaNs in the same place count as equal."""
    a, b = _np(a), _np(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return ~((a == b) | (np.isnan(a) & np.isnan(b)))


def _np(x):
    import torch
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def share(pairs) -> float:
    """Share of parted entries over all (jax, port) pairs."""
    flags = np.concatenate([parted(a, b).ravel() for a, b in pairs])
    return float(flags.mean())


def forward_grid(dtype="bfloat16"):
    """Stage (a): {case: [share of layer 1, layer 2, ...]} over the grid."""
    import jax
    import jax.numpy as jnp
    import torch

    from gmeta_tpu.models import gcn as jgcn
    from gmeta_tpu_torch.config import Config, build_model_config
    from gmeta_tpu_torch.convert import params_from_jax
    from gmeta_tpu_torch.data.pack import TaskBatch
    from gmeta_tpu_torch.meta.maml import batch_to
    from gmeta_tpu_torch.models import gcn
    from test_torch_gcn import _packed_tasks

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out = {}
    for agg in ("dense", "sized"):
        for link in (False, True):
            for h in (1, 2, 3):
                for hidden in (4, 32):
                    store, sets, stacked = _packed_tasks(link, h, seed=h)
                    cfg = Config(h=h, hidden_dim=hidden, link_pred_mode=link,
                                 task_setup="Shared" if link else "Disjoint")
                    spec = build_model_config(cfg, store.feat_dim, 3)
                    jp = jgcn.init_params(jax.random.PRNGKey(h), spec)
                    feats = jnp.asarray(store.features)
                    want = [[] for _ in range(h)]
                    for sg in sets:
                        col = []
                        jgcn.forward(jp, jax.tree.map(jnp.asarray, sg), feats,
                                     spec, compute_dtype=jdt, agg=agg,
                                     collect=col)
                        for i, c in enumerate(col):
                            want[i].append(np.asarray(c))
                    tb = batch_to(TaskBatch(spt=stacked, qry=stacked),
                                  "cpu").spt
                    got = []
                    gcn.forward(params_from_jax([np.asarray(p) for p in jp]),
                                tb, torch.from_numpy(store.features), spec,
                                compute_dtype=tdt, agg=agg, collect=got)
                    key = (f"{agg} {'link' if link else 'node'} h{h} "
                           f"hidden{hidden}")
                    out[key] = [share([(np.stack(w), g)])
                                for w, g in zip(want, got)]
    return out


def _jax_side(spec, n_out, dtype, agg, steps):
    """The JAX functions of stages (b)-(d), vmapped over tasks as
    MetaLearner vmaps them (not yet jitted)."""
    import jax

    from gmeta_tpu.meta import maml as jmaml
    from gmeta_tpu.meta.protonet import proto_loss_spt
    from gmeta_tpu.models.gcn import forward, precompute

    def spt(w, task, feats, dense):
        logits = forward(w, task.spt, feats, spec, dense=dense,
                         compute_dtype=dtype, agg=agg)
        loss, _, protos = proto_loss_spt(logits, task.spt.labels, n_out)
        return loss, protos

    def inner(params, task, feats):
        # maml.py:78-89 (first order, no curve), returning what the
        # reference keeps internal: step 0's loss and gradient, and the
        # fast weights after the last step
        dense = precompute(task.spt, dtype, feats=feats)

        def step(w, _):
            (loss, _), g = jax.value_and_grad(
                lambda w_: spt(w_, task, feats, dense), has_aux=True)(w)
            g = jax.tree.map(jax.lax.stop_gradient, g)
            return jax.tree.map(lambda p, gi: p - LR * gi, w, g), (loss, g)
        w, (losses, gs) = jax.lax.scan(step, params, None, length=steps)
        return losses[0], jax.tree.map(lambda x: x[0], gs), w

    loop = jmaml.make_inner_loop(spec, n_out, LR, steps, first_order=True,
                                 compute_dtype=dtype, remat=False,
                                 track_curve=False, agg=agg)

    def meta_loss(params, batch, feats):
        losses, _ = jax.vmap(loop, in_axes=(None, 0, None))(params, batch,
                                                            feats)
        return losses.mean(), losses

    return (jax.vmap(inner, in_axes=(None, 0, None)),
            jax.value_and_grad(meta_loss, has_aux=True))


def compiled(fn, *args, honour=False):
    """fn jitted and compiled for args. honour=True compiles with
    xla_allow_excess_precision off: XLA then rounds every bf16 value the
    program asks for, where by default it may keep a bf16 operation's
    float32 result when float32 consumes it."""
    import jax
    opts = {"xla_allow_excess_precision": False} if honour else {}
    return jax.jit(fn).lower(*args).compile(compiler_options=opts)


def _port_side(spec, n_out, dtype, agg, steps, params, batch, feats):
    """The port's values of stages (b)-(d) on the T tasks of batch."""
    import torch

    from gmeta_tpu_torch.meta.maml import make_inner_loop
    from gmeta_tpu_torch.meta.protonet import proto_loss_spt
    from gmeta_tpu_torch.models.gcn import forward, precompute

    T = batch.spt.node_gid.shape[0]
    graph = precompute(batch.spt, dtype, feats=feats, agg=agg)
    w = [p.detach().unsqueeze(0).expand((T,) + p.shape).requires_grad_()
         for p in params]
    loss0 = g0 = None
    for k in range(steps):
        logits = forward(w, batch.spt, feats, spec, graph=graph,
                         compute_dtype=dtype, agg=agg)
        loss, _, _ = proto_loss_spt(logits, batch.spt.labels, n_out)
        g = torch.autograd.grad(loss.sum(), w)
        if k == 0:
            loss0, g0 = loss.detach(), g
        w = [(p - LR * gi).detach().requires_grad_() for p, gi in zip(w, g)]
    loop = make_inner_loop(spec, n_out, LR, steps, first_order=True,
                           compute_dtype=dtype, remat=False,
                           track_curve=False, agg=agg)
    theta = [p.detach().clone().requires_grad_() for p in params]
    losses, _ = loop(theta, batch, feats)
    meta_g = torch.autograd.grad(losses.sum() / T, theta)
    return loss0, g0, w, losses.detach(), meta_g


def replay_case(agg):
    """The cut tissue_ppi shape's spec, JAX seed-0 theta, feature table
    and the first meta-batch of bench.run_shape's draw from a pool of
    POOL tasks (numpy)."""
    import jax

    import bench as jbench
    from gmeta_tpu.config import Config as JConfig
    from gmeta_tpu.config import build_model_config
    from gmeta_tpu.models.gcn import init_params
    from gmeta_tpu_torch import bench

    name = "tissue_ppi"
    s = dict(bench.SHAPES[name], **CUT)
    rec = {"buckets": {"P_spt": 128, "B_spt": 2, "E_spt": 1536,
                       "P_qry": 128, "B_qry": 3, "E_qry": 2560},
           "mean_bin_fill": 0.6, "agg": agg, "tasks_per_s": 100.0,
           "edges_per_s": 250_000.0}
    n_out = bench.REPLICA_META[name]["n_out"]
    spec = build_model_config(JConfig(h=2, hidden_dim=s["hidden"],
                                      task_setup="Shared"),
                              bench.REPLICA_META[name]["feat"], n_out)
    init = [np.asarray(p) for p in init_params(jax.random.PRNGKey(0), spec)]
    saved = jbench.POOL
    jbench.POOL = POOL
    try:
        feats, pool, _, _ = jbench._pool_from_parity(name, s, rec)
    finally:
        jbench.POOL = saved
    idx = np.random.RandomState(0).choice(POOL, s["task_num"], replace=False)
    batch = type(pool)(*(type(sg)(*(x[idx] for x in sg)) for sg in pool))
    return spec, n_out, s["update_step"], init, feats, batch


def inner_gradients(agg, dtype="bfloat16", honour=False):
    """Stage (b) alone: (JAX's, the port's) support losses and inner
    gradients of one step from theta, each a list over theta's entries
    with a leading task axis."""
    import jax
    import jax.numpy as jnp
    import torch

    from gmeta_tpu_torch.convert import params_from_jax
    from gmeta_tpu_torch.meta.maml import batch_to

    spec, n_out, steps, init, feats, batch = replay_case(agg)
    j_inner, _ = _jax_side(spec, n_out, getattr(jnp, dtype), agg, 1)
    args = (tuple(jnp.asarray(p) for p in init),
            jax.tree.map(jnp.asarray, batch), jnp.asarray(feats))
    jl, jg, _ = compiled(j_inner, *args, honour=honour)(*args)
    tl, tg, _, _, _ = _port_side(spec, n_out, getattr(torch, dtype), agg, 1,
                                 params_from_jax(init),
                                 batch_to(batch, "cpu"),
                                 torch.from_numpy(feats))
    return (jl, list(jg)), (tl, list(tg))


def replay_stages(agg, dtype="bfloat16", honour=False):
    """Stages (b)-(e) on the cut tissue_ppi pool: {stage: share}. The
    head bias is left out of every share of theta's shape: its gradient
    is zero in exact arithmetic and rounding noise in float32
    (tests/test_torch_meta.py)."""
    import jax
    import jax.numpy as jnp
    import optax
    import torch

    from gmeta_tpu.meta.maml import MetaLearner as JMetaLearner
    from gmeta_tpu_torch.convert import params_from_jax
    from gmeta_tpu_torch.meta.maml import (MetaLearner, adam_init,
                                           adam_update, batch_to)

    spec, n_out, steps, init, feats, batch = replay_case(agg)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j_inner, j_meta = _jax_side(spec, n_out, jdt, agg, steps)
    args = (tuple(jnp.asarray(p) for p in init),
            jax.tree.map(jnp.asarray, batch), jnp.asarray(feats))
    jl0, jg0, jw = compiled(j_inner, *args, honour=honour)(*args)
    (_, jlosses), jmg = compiled(j_meta, *args, honour=honour)(*args)
    kw = dict(update_lr=LR, meta_lr=META_LR, update_step=steps,
              update_step_test=steps, remat=False, seed=0,
              track_curve=False, agg=agg)
    jml = JMetaLearner(spec, n_out, compute_dtype=jdt, **kw)
    jml.set_features(feats)
    targs = (args[0], jml.tx.init(args[0]), args[1], jml._feats)
    jtheta = compiled(jml._train_step, *targs, honour=honour)(*targs)[0]

    def adam(params, grads, state):
        updates, _ = jml.tx.update(grads, state, params)
        return optax.apply_updates(params, updates)
    aargs = (args[0], jmg, targs[1])
    jadam = compiled(adam, *aargs, honour=honour)(*aargs)

    params = params_from_jax(init)
    tl0, tg0, tw, tlosses, tmg = _port_side(
        spec, n_out, tdt, agg, steps, params, batch_to(batch, "cpu"),
        torch.from_numpy(feats))
    tml = MetaLearner(spec, n_out, compute_dtype=tdt, device="cpu", **kw)
    tml.set_params(init)
    tml.set_features(feats)
    tml.train_step(batch)
    tadam, _ = adam_update(params_from_jax([np.asarray(g) for g in jmg]),
                           adam_init(params), params, META_LR)
    body = range(len(init) - 1)           # all but the head bias
    return {
        "b support loss": share([(jl0, tl0)]),
        "b inner gradient": share((jg0[i], tg0[i]) for i in body),
        "c fast weights": share((jw[i], tw[i]) for i in body),
        "d query loss": share([(jlosses, tlosses)]),
        "d meta-gradient": share((jmg[i], tmg[i]) for i in body),
        "e theta after Adam": share((jtheta[i], tml.params[i])
                                    for i in body),
        "e Adam, same gradient": share((jadam[i], tadam[i]) for i in body),
    }


def xla_bias_sum(ct: np.ndarray) -> np.ndarray:
    """numpy emulation of XLA's CPU reduction of a bf16 (T, B, P, C)
    cotangent over (B, P), the bias gradient of a broadcast bf16 add: a
    bf16 accumulator rounded after every add, over windows of 32 along P
    (B outer, P inner within a window), then over the windows in order."""
    import ml_dtypes
    bf = ml_dtypes.bfloat16

    def run(rows):
        acc = rows[0].astype(np.float32)
        for r in rows[1:]:
            acc = (acc + r.astype(np.float32)).astype(bf).astype(np.float32)
        return acc

    T, B, P, C = ct.shape
    parts = [run(ct[:, :, k:k + 32].reshape(T, -1, C).swapaxes(0, 1))
             for k in range(0, P, 32)]
    return run(np.stack(parts))


def bias_reduction(seed=0, shape=(2, 2, 128, 16)):
    """Stage (b)'s bias gradient alone: a bf16 cotangent of the cut
    support's activation shape through the transpose of `h * norm + b`'s
    broadcast add in both packages. {JAX vs port, JAX vs the emulation of
    XLA's bf16 accumulator}: shares of parted entries."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    import torch

    from gmeta_tpu_torch.models.gcn import _bias

    ct = np.random.RandomState(seed).randn(*shape).astype(ml_dtypes.bfloat16)
    T, C = shape[0], shape[-1]

    def add(b):
        return jnp.zeros(shape, jnp.bfloat16) + b[:, None, None, :]
    b0 = jnp.zeros((T, C), jnp.bfloat16)
    _, vjp = jax.vjp(add, b0)
    j = compiled(lambda c: vjp(c)[0], jnp.asarray(ct))(jnp.asarray(ct))
    tb = torch.zeros(T, C, dtype=torch.bfloat16, requires_grad=True)
    out = torch.zeros(shape, dtype=torch.bfloat16) + _bias(tb, 4)
    (t,) = torch.autograd.grad(out, tb, torch.from_numpy(
        ct.astype(np.float32)).to(torch.bfloat16))
    return {"JAX vs port": share([(j, t)]),
            "JAX vs emulated XLA accumulator": share([(j, xla_bias_sum(ct))])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(2)
    res = {"dtype": args.dtype, "a": forward_grid(args.dtype)}
    cols = [(agg, honour) for agg in ("dense", "sized")
            for honour in (False, True)]
    for agg, honour in cols:
        res[f"{agg}{' honour' if honour else ''}"] = replay_stages(
            agg, args.dtype, honour)
    if args.dtype == "bfloat16":
        res["bias reduction"] = bias_reduction()
    layers = [v for shares in res["a"].values() for v in shares]
    print(f"(a) layer activations: {len(layers)} layers over "
          f"{len(res['a'])} cases, max share {max(layers):.4f}")
    for key, shares in res["a"].items():
        print(f"    {key}: " + " ".join(f"{v:.4f}" for v in shares))
    names = [k for k in res if k not in ("dtype", "a", "bias reduction")]
    print(f"{'stage':20s} " + " ".join(f"{k:>14s}" for k in names))
    for stage in res["dense"]:
        print(f"{stage:20s} " + " ".join(f"{res[k][stage]:14.4f}"
                                         for k in names))
    for k, v in res.get("bias reduction", {}).items():
        print(f"bias reduction, {k}: {v:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
