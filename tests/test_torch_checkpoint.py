"""Checkpoint/resume in the port (gmeta_tpu_torch.utils.checkpoint and
run.train): the file layout, reading the JAX package's checkpoints, epoch
and mid-epoch resume in the three execution modes against the straight
run, a JAX run resumed by the port and a port run resumed by the JAX
package, each against the JAX straight run."""

import dataclasses
import os
import pickle

import numpy as np
import pytest
import torch
import jax.numpy as jnp
import optax

from gmeta_tpu.config import Config as JConfig
from gmeta_tpu.data.synthetic import synthetic_disjoint as j_synthetic
from gmeta_tpu.run.train import Trainer as JTrainer
from gmeta_tpu.utils import checkpoint as jckpt
from gmeta_tpu_torch.config import Config
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import AdamState
from gmeta_tpu_torch.run.train import Trainer
from gmeta_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(2)

DATA = dict(num_graphs=1, nodes_per_graph=150, avg_degree=5, feat_dim=8,
            num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=12, h=2,
            sample_nodes=60, seed=3)
CFG = dict(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=8, epoch=2,
           task_num=4, update_step=2, update_step_test=2, eval_batchsz=6,
           meta_lr=1e-3, train_result_report_steps=1, agg="sized")
# the three execution modes, by the Config fields that select them
MODES = {"streaming": {},
         "compact": dict(device_task_pool=True),
         "host_window": dict(device_task_pool=True, compact_pool_hbm_gb=0.0,
                             host_pool_window=1)}


def _state(rng):
    params = (rng.randn(3, 2).astype(np.float32),
              rng.randn(2).astype(np.float32))
    mu = tuple(rng.randn(*p.shape).astype(np.float32) for p in params)
    nu = tuple(rng.rand(*p.shape).astype(np.float32) for p in params)
    return params, mu, nu


def _fields(**kw):
    return dict(dict(max_acc=0.5, epoch=3, batch_in_epoch=-1, step=7), **kw)


def test_save_restore_round_trip(tmp_path):
    params, mu, nu = _state(np.random.RandomState(0))
    opt = AdamState(count=torch.tensor(7, dtype=torch.int32),
                    mu=tuple(map(torch.from_numpy, mu)),
                    nu=tuple(map(torch.from_numpy, nu)))
    d = str(tmp_path / "ck")
    for step in (3, 7):
        path = ckpt.save(d, step, dict(
            _fields(step=step), opt_state=opt,
            params=tuple(torch.from_numpy(p).requires_grad_()
                         for p in params),
            best_params=tuple(map(torch.from_numpy, params))))
    assert os.path.basename(path) == "ckpt_00000007.pkl"
    assert sorted(os.listdir(d)) == ["ckpt_00000003.pkl",
                                     "ckpt_00000007.pkl", "latest"]
    assert os.readlink(os.path.join(d, "latest")) == "ckpt_00000007.pkl"
    assert ckpt.latest_path(d) == path
    assert ckpt.latest_path(str(tmp_path / "none")) is None
    state = ckpt.restore(path)
    assert set(state) == {"params", "opt_state", "best_params", "max_acc",
                          "epoch", "batch_in_epoch", "step"}
    for got in (state["params"], state["best_params"]):
        assert all(isinstance(a, np.ndarray) for a in got)
        for a, b in zip(got, params):
            np.testing.assert_array_equal(a, b)
    o = state["opt_state"]
    assert set(o) == {"count", "mu", "nu"} and int(o["count"]) == 7
    for a, b in zip(o["mu"] + o["nu"], mu + nu):
        np.testing.assert_array_equal(a, b)
    assert int(state["step"]) == 7 and float(state["max_acc"]) == 0.5


def test_restore_reads_a_jax_checkpoint(tmp_path):
    params, mu, nu = _state(np.random.RandomState(1))
    jparams = tuple(map(jnp.asarray, params))
    opt = optax.adam(1e-3).init(jparams)
    opt = (opt[0]._replace(count=jnp.asarray(5, jnp.int32),
                           mu=tuple(map(jnp.asarray, mu)),
                           nu=tuple(map(jnp.asarray, nu))), opt[1])
    path = jckpt.save(str(tmp_path), 5, dict(
        _fields(step=5, batch_in_epoch=2), params=jparams, opt_state=opt,
        best_params=jparams))
    assert ckpt.latest_path(str(tmp_path)) == path
    state = ckpt.restore(path)
    o = state["opt_state"]
    assert int(o["count"]) == 5 and o["count"].dtype == np.int32
    for a, b in zip(o["mu"] + o["nu"] + state["params"], mu + nu + params):
        np.testing.assert_array_equal(a, b)
    assert int(state["batch_in_epoch"]) == 2


def test_restore_refuses_other_classes(tmp_path):
    path = tmp_path / "ckpt_00000001.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": (), "opt_state": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix|nt"):
        ckpt.restore(str(path))


def _params(trainer):
    return [p.detach().numpy().copy() for p in trainer.learner.params]


def _assert_equal_params(a, b):
    for x, y in zip(_params(a), _params(b)):
        np.testing.assert_array_equal(x, y)


def test_epoch_resume_reproduces_state(tmp_path):
    store, ds = synthetic_disjoint(**DATA)
    full = Trainer(Config(**CFG), store, ds, labels_num=3, device="cpu")
    res_full = full.fit()
    cfg = Config(**CFG, checkpoint_dir=str(tmp_path / "ck"))
    t1 = Trainer(dataclasses.replace(cfg, epoch=1), store, ds, labels_num=3,
                 device="cpu")
    assert t1.fit().epochs_run == 1
    t2 = Trainer(cfg, store, ds, labels_num=3, device="cpu")
    assert (t2.start_epoch, t2.start_batch, t2.global_step) == (1, 0, 3)
    res = t2.fit()
    assert res.epochs_run == 1 and res.global_step == 6
    _assert_equal_params(full, t2)
    assert res.test_acc_final == res_full.test_acc_final
    assert res.val_max_acc == res_full.val_max_acc


# successful train calls before the kill, chosen so that the newest
# checkpoint is the one after step 1 of epoch 2. The host-windowed loop
# saves window N when window N+1 is already dispatched (one call later).
KILL_AFTER = {"streaming": ("train_step", 4),
              "compact": ("train_steps_from_compact", 4),
              "host_window": ("train_steps_from_window", 5)}


class _Kill(Exception):
    pass


@pytest.mark.parametrize("mode", sorted(MODES))
def test_midepoch_kill_resume_matches_straight_run(tmp_path, mode):
    store, ds = synthetic_disjoint(**DATA)
    cfg = Config(**CFG, **MODES[mode])
    full = Trainer(cfg, store, ds, labels_num=3, device="cpu")
    res_full = full.fit()

    cfg_k = dataclasses.replace(cfg, checkpoint_dir=str(tmp_path / "ck"),
                                checkpoint_every_steps=1)
    tr_k = Trainer(cfg_k, store, ds, labels_num=3, device="cpu")
    name, n_ok = KILL_AFTER[mode]
    orig = getattr(tr_k.learner, name)
    calls = {"n": 0}

    def killing(*a):
        if calls["n"] == n_ok:
            raise _Kill()
        calls["n"] += 1
        return orig(*a)

    setattr(tr_k.learner, name, killing)
    with pytest.raises(_Kill):
        tr_k.fit()

    tr_r = Trainer(cfg_k, store, ds, labels_num=3, device="cpu")
    assert (tr_r.start_epoch, tr_r.start_batch, tr_r.global_step) \
        == (1, 1, 4)
    res_r = tr_r.fit()
    assert res_r.global_step == res_full.global_step == 6
    assert res_r.epochs_run == 1
    _assert_equal_params(full, tr_r)
    assert res_r.test_acc_final == res_full.test_acc_final


def test_host_window_snapshot_is_that_windows_state(tmp_path):
    """theta is updated in place, and the host-windowed loop saves window
    N after window N+1's steps are dispatched: the snapshot must still be
    the state after window N, as the straight run has it."""
    store, ds = synthetic_disjoint(**DATA)
    cfg = Config(**dict(CFG, epoch=1), **dict(MODES["host_window"],
                                               host_pool_window=2),
                 checkpoint_dir=str(tmp_path / "ck"),
                 checkpoint_every_steps=2)
    tr = Trainer(cfg, store, ds, labels_num=3, device="cpu")
    tr.fit()
    state = ckpt.restore(os.path.join(cfg.checkpoint_dir,
                                      "ckpt_00000002.pkl"))
    assert int(state["batch_in_epoch"]) == 2 and int(state["step"]) == 2

    ref = Trainer(Config(**CFG), store, ds, labels_num=3,
                  device="cpu").learner
    batches = ds["train"].batches(4, shuffle=True, seed=cfg.seed)
    for _ in range(2):
        ref.train_step(next(batches))
    for a, b in zip(state["params"], ref.params):
        np.testing.assert_array_equal(a, b.detach().numpy())
    o = state["opt_state"]
    assert int(o["count"]) == 2
    for a, b in zip(o["mu"] + o["nu"], ref.opt_state.mu + ref.opt_state.nu):
        np.testing.assert_array_equal(a, b.numpy())
    # and the run went on past it: theta after 3 steps is not the snapshot
    assert not all(np.array_equal(a, b.detach().numpy())
                   for a, b in zip(state["params"], tr.learner.params))


def test_port_resumes_a_jax_run(tmp_path):
    """Epoch 1 by the JAX Trainer with a checkpoint, epoch 2 by the port's
    Trainer from that checkpoint: the result of the JAX straight run."""
    jstore, jds = j_synthetic(**DATA)
    jcfg = JConfig(**CFG)
    jfull = JTrainer(jcfg, jstore, jds, labels_num=3)
    jres = jfull.fit()
    ck = str(tmp_path / "ck")
    j1 = JTrainer(dataclasses.replace(jcfg, epoch=1, checkpoint_dir=ck),
                  jstore, jds, labels_num=3)
    j1.fit()
    after1 = [np.asarray(p) for p in j1.learner.params]

    store, ds = synthetic_disjoint(**DATA)
    tr = Trainer(Config(**CFG, checkpoint_dir=ck), store, ds, labels_num=3,
                 device="cpu")
    assert (tr.start_epoch, tr.start_batch, tr.global_step) == (1, 0, 3)
    assert int(tr.learner.opt_state.count) == 3
    res = tr.fit()
    assert res.epochs_run == 1 and res.global_step == jres.global_step == 6
    for f in ("test_acc_ref", "test_acc_final", "best_test_acc",
              "early_stopped_ref", "val_max_acc"):
        np.testing.assert_allclose(getattr(res, f), getattr(jres, f),
                                   atol=1e-6, err_msg=f)
    # every parameter but the head bias, whose meta-gradient is
    # analytically zero (tests/test_torch_meta.py::_assert_params_close)
    for i, (a, b) in enumerate(zip(jfull.learner.params, tr.learner.params)):
        a, b = np.asarray(a), b.detach().numpy()
        if i == len(after1) - 1:
            assert np.abs(b - after1[i]).max() <= 3 * CFG["meta_lr"] * 1.001
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5,
                                       err_msg=f"param {i}")


def test_jax_resumes_a_port_run(tmp_path):
    """Epoch 1 by the port's Trainer with a checkpoint (optax's layout,
    written without optax), epoch 2 by the JAX Trainer from that
    checkpoint: the result of the JAX straight run."""
    jstore, jds = j_synthetic(**DATA)
    jcfg = JConfig(**CFG)
    jfull = JTrainer(jcfg, jstore, jds, labels_num=3)
    jres = jfull.fit()
    # the port starts from the JAX run's initial theta
    init = [np.asarray(p) for p in
            JTrainer(jcfg, jstore, jds, labels_num=3).learner.params]

    ck = str(tmp_path / "ck")
    store, ds = synthetic_disjoint(**DATA)
    p1 = Trainer(Config(**dict(CFG, epoch=1), checkpoint_dir=ck), store, ds,
                 labels_num=3, device="cpu")
    p1.learner.set_params(params_from_jax(init))
    p1.best_params = p1.learner.snapshot()
    p1.fit()
    after1 = _params(p1)
    with open(ckpt.latest_path(ck), "rb") as f:
        state = pickle.load(f)          # optax importable here
    assert isinstance(state["opt_state"][0], optax.ScaleByAdamState)
    assert isinstance(state["opt_state"][1], optax.EmptyState)
    assert state["opt_state"][0].count.dtype == np.int32

    jr = JTrainer(dataclasses.replace(jcfg, checkpoint_dir=ck), jstore, jds,
                  labels_num=3)
    assert (jr.start_epoch, jr.start_batch, jr.global_step) == (1, 0, 3)
    assert int(jr.learner.opt_state[0].count) == 3
    res = jr.fit()
    assert res.epochs_run == 1 and res.global_step == jres.global_step == 6
    for f in ("test_acc_ref", "test_acc_final", "best_test_acc",
              "early_stopped_ref", "val_max_acc"):
        np.testing.assert_allclose(getattr(res, f), getattr(jres, f),
                                   atol=1e-6, err_msg=f)
    # every parameter but the head bias (see test_port_resumes_a_jax_run)
    for i, (a, b) in enumerate(zip(jfull.learner.params, jr.learner.params)):
        a, b = np.asarray(a), np.asarray(b)
        if i == len(after1) - 1:
            assert np.abs(b - after1[i]).max() <= 3 * CFG["meta_lr"] * 1.001
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5,
                                       err_msg=f"param {i}")


def test_save_writes_optax_layout_without_optax(tmp_path):
    """The pickle names optax's classes, and restoring it maps them back
    without importing optax (tests/test_torch_isolation.py runs a resume
    in a fresh process)."""
    params, mu, nu = _state(np.random.RandomState(2))
    opt = AdamState(count=torch.tensor(4, dtype=torch.int32),
                    mu=tuple(map(torch.from_numpy, mu)),
                    nu=tuple(map(torch.from_numpy, nu)))
    path = ckpt.save(str(tmp_path), 4, dict(
        _fields(step=4), params=tuple(map(torch.from_numpy, params)),
        opt_state=opt, best_params=tuple(map(torch.from_numpy, params))))
    import pickletools
    with open(path, "rb") as f:
        ops = [(op.name, arg) for op, arg, _ in pickletools.genops(f)]
    strings = [a for name, a in ops if isinstance(a, str)]
    for module, cls in (("optax._src.transform", "ScaleByAdamState"),
                        ("optax._src.base", "EmptyState")):
        i = strings.index(module)
        assert strings[i + 1] == cls
    state = ckpt.restore(path)
    o = state["opt_state"]
    assert set(o) == {"count", "mu", "nu"} and int(o["count"]) == 4
    for a, b in zip(o["mu"] + o["nu"], mu + nu):
        np.testing.assert_array_equal(a, b)
    # a checkpoint of the port's former layout (a dict) still restores
    old = tmp_path / "old" / "ckpt_00000001.pkl"
    old.parent.mkdir()
    with open(old, "wb") as f:
        pickle.dump(dict(_fields(step=1), params=params, best_params=params,
                         opt_state={"count": np.int32(1), "mu": mu,
                                    "nu": nu}), f)
    o = ckpt.restore(str(old))["opt_state"]
    assert int(o["count"]) == 1
    for a, b in zip(o["mu"] + o["nu"], mu + nu):
        np.testing.assert_array_equal(a, b)
