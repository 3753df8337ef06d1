"""The port's pool and window modes (gmeta_tpu_torch.meta.maml pool API,
run.train's pool loops) against the JAX package: the int32 wire codec bit
for bit, the device decode field by field, each K-step entry point against
the same steps one at a time, and whole fits in the three modes, on the
tiny data of tests/test_trainer.py."""

import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from gmeta_tpu.config import Config as JConfig
from gmeta_tpu.data.synthetic import synthetic_disjoint as j_synthetic
from gmeta_tpu.meta.maml import MetaLearner as JMetaLearner
from gmeta_tpu.run.train import Trainer as JTrainer
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.convert import params_from_jax
from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner, batch_to
from gmeta_tpu_torch.meta.maml import take_tasks as _take
from gmeta_tpu_torch.run.train import Trainer

torch.set_num_threads(2)

DATA = dict(num_graphs=1, nodes_per_graph=150, avg_degree=5, feat_dim=8,
            num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=12, h=2,
            sample_nodes=60, seed=3)
CFG = dict(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=8, epoch=2,
           task_num=4, update_step=2, update_step_test=2, eval_batchsz=6,
           train_result_report_steps=2, agg="sized")
K, T = 2, 4      # a window of 2 meta-steps of 4 tasks


def _records(path):
    return [json.loads(line) for line in open(path)]


def _two_word_set(rng, n, B, P, E, S):
    """n packed sets whose buckets leave no room for one-word edges
    (2*bits_p + bits_b > 31): live rows [0, fill), real edges inside their
    bin's live rows at [0, n_edges), pad edges (src 0, dst B*P-1)."""
    node_gid = np.zeros((n, B, P), np.int32)
    node_mask = np.zeros((n, B, P), np.float32)
    src = np.zeros((n, E), np.int32)
    dst = np.full((n, E), B * P - 1, np.int32)
    emask = np.zeros((n, E), np.float32)
    fill = rng.randint(1, P + 1, (n, B)).astype(np.int32)
    centers = np.zeros((n, S, 2), np.int32)
    for t in range(n):
        for b in range(B):
            node_gid[t, b, :fill[t, b]] = rng.randint(0, 1000, fill[t, b])
            node_mask[t, b, :fill[t, b]] = 1
        n_e = rng.randint(0, E + 1)
        bins = np.sort(rng.randint(0, B, n_e))
        src[t, :n_e] = bins * P + rng.randint(0, fill[t, bins])
        dst[t, :n_e] = bins * P + rng.randint(0, fill[t, bins])
        emask[t, :n_e] = 1
        cb = rng.randint(0, B, S)
        centers[t] = (cb * P + rng.randint(0, fill[t, cb]))[:, None]
    return SubgraphSet(node_gid, node_mask, src, dst, emask, centers,
                       rng.randint(0, 3, (n, S)).astype(np.int32), fill)


@pytest.fixture(scope="module")
def chunks():
    """{case: (port chunk, JAX chunk)} of K*T tasks each: "packed" from
    each package's own pool of the tiny data (one-word edges), "two_word"
    built in numpy with P = 2**15, B = 3 (two edge words)."""
    jstore, jds = j_synthetic(**DATA)
    store, ds = synthetic_disjoint(**DATA)
    rows = np.random.RandomState(0).permutation(len(ds["train"]))[:K * T]
    rng = np.random.RandomState(1)
    two = TaskBatch(spt=_two_word_set(rng, K * T, 3, 2 ** 15, 96, 6),
                    qry=_two_word_set(rng, K * T, 3, 2 ** 15, 160, 9))
    return {"packed": (_take(ds["train"].stacked_pool(), rows),
                       _take(jds["train"].stacked_pool(), rows)),
            "two_word": (two, two)}


@pytest.fixture(scope="module")
def jax_learner():
    spec = build_model_config(Config(hidden_dim=8), 8, 3)
    return JMetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3,
                        update_step=1, update_step_test=1)


@pytest.mark.parametrize("case", ["packed", "two_word"])
def test_encoding_matches_jax(chunks, jax_learner, case):
    chunk, jchunk = chunks[case]
    buf, codec = MetaLearner.encode_window(chunk, T)
    jbuf, jcodec = jax_learner.encode_window(jchunk, T)
    assert codec == jcodec and buf.dtype == np.int32
    assert (codec[2][4] == 0) == (case == "two_word")      # bits_p
    np.testing.assert_array_equal(buf, jbuf)
    out = np.full(buf.size + 7, -1, np.int32)
    np.testing.assert_array_equal(
        MetaLearner.encode_window(chunk, T, out=out)[0], buf)
    assert (out[buf.size:] == -1).all()
    for sg, jsg in zip(chunk, jchunk):
        leaves, meta = MetaLearner._encode_set_leaves(sg)
        jleaves, jmeta = jax_learner._encode_set_leaves(jsg)
        assert meta == jmeta and len(leaves) == len(jleaves)
        for a, b in zip(leaves, jleaves):
            np.testing.assert_array_equal(a, b)
    assert MetaLearner.compact_pool_bytes(chunk) \
        == JMetaLearner.compact_pool_bytes(jchunk) == buf.nbytes


@pytest.mark.parametrize("case", ["packed", "two_word"])
def test_decoding_matches_jax_and_batch_to(chunks, jax_learner, case):
    chunk, jchunk = chunks[case]
    buf, codec = MetaLearner.encode_window(chunk, T)
    ml = MetaLearner(build_model_config(Config(hidden_dim=8), 8, 3), 3,
                     update_lr=0.05, meta_lr=1e-3, update_step=1,
                     update_step_test=1, device="cpu")
    dev, copied = ml.put_buffer(buf, codec)
    assert copied is None
    got = ml._decode_window(dev)
    jax_learner._codec = codec
    want = jax_learner._decode_window(jnp.asarray(buf))
    for name, s, j in ((n, s, j) for sg, jsg in zip(got, want)
                       for n, s, j in zip(SubgraphSet._fields, sg, jsg)):
        assert tuple(s.shape) == (K, T) + tuple(j.shape[2:]), name
        np.testing.assert_array_equal(s.numpy(), np.asarray(j), name)
    # one step at a time, as the train loops decode: batch_to of the packed
    # batch, but for the pad edges' sources (their dst's bin base)
    spt, qry = ml._window_leaves(dev)
    for k in range(K):
        ref = batch_to(_take(chunk, slice(k * T, (k + 1) * T)), "cpu")
        for leaves, meta, rsg in ((spt, codec[2], ref.spt),
                                  (qry, codec[3], ref.qry)):
            sg = ml._build_set([l[k] for l in leaves], meta)
            P, bits_p = meta[1], meta[4]
            pad = sg.edge_mask == 0
            assert pad.any() and (~pad).any()
            for name, a, b in zip(SubgraphSet._fields, sg, rsg):
                assert a.dtype == b.dtype, name
                if name == "edge_src":
                    assert torch.equal(a[~pad], b[~pad])
                    want = sg.edge_dst // P * P if bits_p else b
                    assert torch.equal(a[pad], want[pad])
                else:
                    assert torch.equal(a, b), name


def _learner(ds):
    store = ds["train"].store
    ml = MetaLearner(build_model_config(Config(hidden_dim=8), store.feat_dim,
                                        3), 3,
                     update_lr=0.05, meta_lr=1e-3, update_step=2,
                     update_step_test=2, seed=5, agg="sized", device="cpu")
    ml.set_features(store.features)
    return ml


@pytest.mark.parametrize("mode", ["pool", "pool_step", "compact", "window"])
def test_pool_entry_points_match_single_steps(mode):
    """Each K-step entry point = K train_steps on the same batches, bit for
    bit, with the per-step metrics stacked along a leading axis."""
    store, ds = synthetic_disjoint(**DATA)
    pool = ds["train"].stacked_pool()
    idx_mat = np.random.RandomState(2).permutation(len(ds["train"]))[
        :K * T].reshape(K, T)
    ref = _learner(ds)
    ms = [ref.train_step(_take(pool, rows)) for rows in idx_mat]
    want = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}

    ml = _learner(ds)
    if mode == "pool":
        ml.set_task_pool(pool)
        got = ml.train_steps_from_pool(idx_mat)
    elif mode == "pool_step":
        ml.set_task_pool(pool)
        ms = [ml.train_step_from_pool(rows) for rows in idx_mat]
        got = {k: torch.stack([m[k] for m in ms]) for k in ms[0]}
    elif mode == "compact":
        ml.set_task_pool_compact(pool)
        assert ml.compact_pool_device_bytes() \
            == MetaLearner.compact_pool_bytes(pool)
        got = ml.train_steps_from_compact(idx_mat)
    else:
        dev = ml.put_window(_take(pool, idx_mat.reshape(-1)), T)
        got = ml.train_steps_from_window(dev, T)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].shape[0] == K and torch.equal(got[k], want[k]), k
    for a, b in zip(ml.params, ref.params):
        assert torch.equal(a, b)
    assert torch.equal(ml.opt_state.count, ref.opt_state.count)


def _spy_host_pool(trainer):
    hit = {"n": 0}
    orig = trainer._fit_host_pool

    def spy(*a, **k):
        hit["n"] += 1
        return orig(*a, **k)

    trainer._fit_host_pool = spy
    return hit


def test_compact_fit_matches_jax(tmp_path):
    jstore, jds = j_synthetic(**DATA)
    jcfg = JConfig(**CFG, device_task_pool=True,
                   metrics_path=str(tmp_path / "jax.jsonl"))
    jtr = JTrainer(jcfg, jstore, jds, labels_num=3)
    start = [np.asarray(p) for p in jtr.learner.params]
    jres = jtr.fit()

    store, ds = synthetic_disjoint(**DATA)
    cfg = Config(**CFG, device_task_pool=True,
                 metrics_path=str(tmp_path / "port.jsonl"))
    tr = Trainer(cfg, store, ds, labels_num=3, device="cpu")
    tr.learner.set_params(params_from_jax(start))
    tr.best_params = tr.learner.snapshot()
    hit = _spy_host_pool(tr)
    res = tr.fit()
    assert hit["n"] == 0 and tr.learner._cpool is not None

    assert res.global_step == jres.global_step == 6
    assert res.epochs_run == jres.epochs_run == 2
    for f in ("test_acc_ref", "test_acc_final", "best_test_acc",
              "early_stopped_ref", "val_max_acc"):
        np.testing.assert_allclose(getattr(res, f), getattr(jres, f),
                                   atol=1e-6, err_msg=f)
    port, ref = _records(cfg.metrics_path), _records(jcfg.metrics_path)
    np.testing.assert_allclose(
        [r["acc_curve"] for r in port if r["kind"] == "val"],
        [r["acc_curve"] for r in ref if r["kind"] == "val"], atol=1e-6)
    windows = [(r["epoch"], r["step"]) for r in port
               if r["kind"] == "train_window"]
    assert windows == [(r["epoch"], r["step"]) for r in ref
                       if r["kind"] == "train_window"]
    assert windows == [(0, 2), (0, 3), (1, 5), (1, 6)]
    assert [r["mode"] for r in port if r["kind"] == "task_pool"] \
        == ["compact"]
    # every parameter but the head bias, whose meta-gradient is
    # analytically zero (tests/test_torch_meta.py::_assert_params_close)
    for i, (a, b) in enumerate(zip(jtr.learner.params, tr.learner.params)):
        a, b = np.asarray(a), b.detach().numpy()
        if i == len(start) - 1:
            assert np.abs(b - start[i]).max() <= 6 * cfg.meta_lr * 1.001
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=2e-5,
                                       err_msg=f"param {i}")


def test_host_pool_equals_compact_bitwise(tmp_path):
    store, ds = synthetic_disjoint(**DATA)
    tr_dev = Trainer(Config(**CFG, device_task_pool=True), store, ds,
                     labels_num=3, device="cpu")
    r_dev = tr_dev.fit()
    # compact_pool_hbm_gb=0 sends the pool to the host-windowed variant
    cfg = Config(**CFG, device_task_pool=True, compact_pool_hbm_gb=0.0,
                 host_pool_window=2, metrics_path=str(tmp_path / "hp.jsonl"))
    tr_host = Trainer(cfg, store, ds, labels_num=3, device="cpu")
    hit = _spy_host_pool(tr_host)
    r_host = tr_host.fit()
    assert hit["n"] == 1, "host-windowed pool path was not entered"
    assert tr_host.learner._cpool is None
    for a, b in zip(tr_dev.learner.params, tr_host.learner.params):
        assert torch.equal(a, b)
    assert r_host == r_dev
    lines = _records(cfg.metrics_path)
    assert [r["mode"] for r in lines if r["kind"] == "task_pool"] \
        == ["host_window"]
    assert [(r["epoch"], r["step"]) for r in lines
            if r["kind"] == "train_window"] == [(0, 2), (0, 3), (1, 5), (1, 6)]


def test_compact_chunked_matches_streaming(tmp_path):
    store, ds = synthetic_disjoint(**DATA)
    tr_s = Trainer(Config(**CFG), store, ds, labels_num=3, device="cpu")
    r_s = tr_s.fit()
    cfg_c = Config(**CFG, device_task_pool=True, task_vmap_chunk=3,
                   metrics_path=str(tmp_path / "c.jsonl"))
    tr_c = Trainer(cfg_c, store, ds, labels_num=3, device="cpu")
    r_c = tr_c.fit()
    assert tr_c.learner._cpool is not None and tr_c.task_chunk == 3
    assert any(r["kind"] == "train_window" for r in _records(
        cfg_c.metrics_path))
    for a, b in zip(tr_s.learner.params, tr_c.learner.params):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert r_c.global_step == r_s.global_step == 6
    assert abs(r_s.test_acc_final - r_c.test_acc_final) < 1e-6


@pytest.mark.parametrize("mode", ["streaming", "compact", "host_window"])
def test_profile_dir_writes_a_trace(tmp_path, mode):
    over = {"streaming": dict(profile_steps=2),
            "compact": dict(device_task_pool=True),
            "host_window": dict(device_task_pool=True,
                                compact_pool_hbm_gb=0.0,
                                host_pool_window=1)}[mode]
    store, ds = synthetic_disjoint(**DATA)
    cfg = Config(**dict(CFG, epoch=1, train_result_report_steps=1),
                 profile_dir=str(tmp_path / "trace"),
                 metrics_path=str(tmp_path / "m.jsonl"), **over)
    Trainer(cfg, store, ds, labels_num=3, device="cpu").fit()
    traces = os.listdir(cfg.profile_dir)
    assert len(traces) == 1 and traces[0].endswith(".json"), traces
    with open(os.path.join(cfg.profile_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    # the spans show in the Chrome trace as ranges of the host's timeline
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    assert {"step", "decode", "graph", "inner", "outer", "agg"} <= names
    # the window's spans: one record, each name counted, device ms a step
    spans = [r for r in _records(cfg.metrics_path) if r["kind"] == "spans"]
    assert len(spans) == 1, spans
    rec = spans[0]
    # the host pool's window closes once the next window is dispatched
    steps = {"streaming": 2, "compact": 1, "host_window": 2}[mode]
    assert rec["steps"] == rec["count"]["step"] == steps
    per_step = {"decode": 1, "graph": 1, "outer": 2,
                "inner": CFG["update_step"], "curve": CFG["update_step"]}
    for name, n in per_step.items():
        assert rec["count"][name] == n * steps, (name, rec)
    assert rec["count"]["agg"] > 0
    assert set(rec["ms_per_step"]) == set(rec["count"])
    assert all(v > 0 for v in rec["ms_per_step"].values())
    assert rec["ms_per_step"]["step"] >= rec["ms_per_step"]["inner"]
