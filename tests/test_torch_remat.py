"""Inner-step recomputation (`remat`) in the port's ProtoMAML: a remat step
equals the step without it, first- and second-order, and equals the JAX
package's MetaLearner(remat=True); the Trainer and the CLI take
`remat_inner`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gmeta_tpu.meta import maml as jmaml
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to, make_inner_loop
from gmeta_tpu_torch.run.train import Trainer

torch.set_num_threads(2)

LR, META_LR = 0.05, 1e-3


@pytest.fixture(scope="module")
def case():
    store, ds = synthetic_disjoint(
        num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=8,
        num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=8, h=2,
        sample_nodes=96, seed=3)
    spec = build_model_config(Config(n_way=3, k_spt=3, k_qry=4, h=2,
                                     hidden_dim=16), store.feat_dim, 3)
    batch = next(ds["train"].batches(4, shuffle=False))
    jparams = [np.asarray(p) for p in
               jmaml.init_params(jax.random.PRNGKey(0), spec)]
    return store, ds, spec, batch, jparams


def _learner(case, remat, first_order, agg="sized", **kw):
    store, _, spec, _, jparams = case
    t = MetaLearner(spec, 3, update_lr=LR, meta_lr=META_LR, update_step=3,
                    update_step_test=3, first_order=first_order, remat=remat,
                    agg=agg, device="cpu", **kw)
    t.set_params(params_from_jax(jparams))
    t.set_features(store.features)
    return t


@pytest.mark.parametrize("track_curve", [True, False])
@pytest.mark.parametrize("first_order", [True, False])
def test_remat_meta_gradient_equals_plain(case, first_order, track_curve):
    """The inner loop's losses, curves and meta-gradient with every step
    checkpointed equal those without (rtol 1e-6): the checkpointed last
    step survives its two backward passes (the retained inner gradient,
    then the meta-gradient through its prototypes), and create_graph
    survives recomputation."""
    store, _, spec, batch, jparams = case
    out = []
    for remat in (False, True):
        inner = make_inner_loop(spec, 3, LR, 3, first_order=first_order,
                                track_curve=track_curve, remat=remat,
                                agg="sized")
        params = tuple(p.requires_grad_() for p in params_from_jax(jparams))
        losses, aux = inner(params, batch_to(batch, "cpu"),
                            torch.from_numpy(store.features))
        grads = torch.autograd.grad(losses.mean(), params)
        out.append((losses.detach(), aux, grads))
    (l0, a0, g0), (l1, a1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for x, y in zip(a1, a0):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=0)
    for i, (x, y) in enumerate(zip(g1[:-1], g0[:-1])):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-12,
                                   msg=f"grad {i}")
    # head bias: analytically zero (tests/test_torch_meta.py)
    assert g1[-1].abs().max() < 1e-6


@pytest.mark.parametrize("first_order", [True, False])
def test_remat_train_steps_equal_plain(case, first_order):
    """Two meta-steps (Adam included), chunked into 2 tasks, with and
    without remat."""
    batch = case[3]
    runs = []
    for remat in (False, True):
        t = _learner(case, remat, first_order, task_chunk=2)
        ms = [t.train_step(batch) for _ in range(2)]
        runs.append((ms, t.params))
    (m0, p0), (m1, p1) = runs
    for a, b in zip(m0, m1):
        torch.testing.assert_close(b["meta_loss"], a["meta_loss"],
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(b["accs"], a["accs"], rtol=1e-6, atol=0)
    for i, (x, y) in enumerate(zip(p1[:-1], p0[:-1])):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9,
                                   msg=f"param {i}")
    assert (p1[-1] - p0[-1]).abs().max() <= 2 * 2 * META_LR * 1.001


@pytest.mark.parametrize("first_order", [True, False])
def test_remat_train_step_matches_jax_remat(case, first_order):
    from test_torch_meta import _assert_params_close
    store, _, spec, batch, jparams = case
    j = jmaml.MetaLearner(spec, 3, update_lr=LR, meta_lr=META_LR,
                          update_step=3, update_step_test=3,
                          first_order=first_order, remat=True, seed=0,
                          agg="sized")
    j.params = tuple(jnp.asarray(p) for p in jparams)
    j.opt_state = j.tx.init(j.params)
    j.set_features(store.features)
    t = _learner(case, True, first_order)
    mj, mt = j.train_step(batch), t.train_step(batch)
    np.testing.assert_allclose(mt["meta_loss"].item(),
                               float(mj["meta_loss"]), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(mt["accs"].numpy(), np.asarray(mj["accs"]),
                               rtol=1e-4, atol=1e-5)
    _assert_params_close(j.params, t.params, jparams)


def test_trainer_fit_with_remat_inner_equals_without(case):
    store, ds = case[0], case[1]
    cfg = dict(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=16, epoch=1,
               task_num=4, update_step=2, update_step_test=2,
               update_lr=LR, meta_lr=META_LR, train_result_report_steps=1,
               agg="sized")
    fits = []
    for remat in (False, True):
        tr = Trainer(Config(**cfg, remat_inner=remat), store, ds,
                     labels_num=3, device="cpu")
        fits.append((tr.fit(), tr.learner.params))
    (r0, p0), (r1, p1) = fits
    assert r1 == r0
    for x, y in zip(p1[:-1], p0[:-1]):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-9)
