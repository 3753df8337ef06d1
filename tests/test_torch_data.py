"""The port's host layer (gmeta_tpu_torch.data) against the JAX package's:
the same seeds give bit-identical episodes, buckets and packed batches;
and what agg="auto" resolves to (data/pipeline.py `agg_for`): the JAX
package's rule on the CPU, the card's crossover on a CUDA device."""

import types

import numpy as np
import pytest
import torch

from gmeta_tpu.data import pipeline as jpipeline
from gmeta_tpu.data import synthetic as jsyn
from gmeta_tpu.data.pack import stack_tasks as jax_stack_tasks
from gmeta_tpu_torch import bench
from gmeta_tpu_torch.config import PRESETS, Config, build_model_config
from gmeta_tpu_torch.data import synthetic as tsyn
from gmeta_tpu_torch.data.pack import stack_tasks
from gmeta_tpu_torch.data.pipeline import (CARD_CROSSOVER, SplitGeometry,
                                           agg_for, aggregation_width,
                                           card_crossover, edges_per_slot)
from gmeta_tpu_torch.run.train import Trainer

torch.set_num_threads(2)

REGIMES = {
    "disjoint": ("synthetic_disjoint", dict(
        num_graphs=1, nodes_per_graph=300, avg_degree=6, feat_dim=8,
        num_classes=9, n_way=3, k_spt=3, k_qry=4, batchsz=10, h=2,
        sample_nodes=48, seed=3, homophily=0.3)),
    "shared": ("synthetic_shared", dict(
        num_graphs=5, nodes_per_graph=120, avg_degree=6, feat_dim=8,
        num_classes=3, k_spt=2, k_qry=3, batchsz=8, h=1, sample_nodes=40,
        seed=1)),
    "link_pred": ("synthetic_link_pred", dict(
        num_graphs=5, nodes_per_graph=120, avg_degree=6, feat_dim=8,
        k_spt=3, k_qry=3, batchsz=8, sample_nodes=60, seed=2)),
}


def _assert_batches_equal(a, b):
    for set_a, set_b in zip(a, b):
        for name, x, y in zip(set_a._fields, set_a, set_b):
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_synthetic_regimes_bit_identical(regime):
    fn, kw = REGIMES[regime]
    jstore, jds = getattr(jsyn, fn)(**kw)
    tstore, tds = getattr(tsyn, fn)(**kw)
    np.testing.assert_array_equal(jstore.features, tstore.features)
    for split in ("train", "val", "test"):
        j, t = jds[split], tds[split]
        for attr in ("P_spt", "E_spt", "B_spt", "P_qry", "E_qry", "B_qry",
                     "mean_bin_fill", "suggested_agg", "mean_edges_per_task",
                     "num_classes"):
            assert getattr(j, attr) == getattr(t, attr), (split, attr)
        assert len(j) == len(t)
        for jb, tb in zip(j.batches(3, shuffle=True, seed=5, drop_last=False,
                                    pad_last=True),
                          t.batches(3, shuffle=True, seed=5, drop_last=False,
                                    pad_last=True)):
            _assert_batches_equal(jb, tb)


def test_batches_stream_options_match():
    """seed / skip_batches / num_workers give the JAX package's stream."""
    fn, kw = REGIMES["disjoint"]
    _, jds = getattr(jsyn, fn)(**kw)
    _, tds = getattr(tsyn, fn)(**kw)
    j = list(jds["train"].batches(2, seed=9, skip_batches=1, num_workers=2))
    t = list(tds["train"].batches(2, seed=9, skip_batches=1, num_workers=2))
    assert len(j) == len(t) == 4
    for jb, tb in zip(j, t):
        _assert_batches_equal(jb, tb)


def test_numpy_stack_tasks_equals_jax():
    fn, kw = REGIMES["link_pred"]
    _, ds = getattr(tsyn, fn)(**kw)
    tasks = [ds["train"].pack_task(t) for t in ds["train"].tasks[:4]]
    _assert_batches_equal(jax_stack_tasks(tasks), stack_tasks(tasks))


# --- agg="auto": the JAX rule off the card, the card's crossover on it -------

def _geometry(P, per_slot, fill=0.6, B=(4, 6)):
    slots = (B[0] + B[1]) * P
    return SplitGeometry(P, B[0], 2048, P, B[1], 4096, per_slot * slots,
                         fill)


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_auto_on_the_cpu_is_the_jax_rule(regime):
    """Off the card `agg_for` is `suggested_agg`, the JAX package's rule,
    for every split of every regime."""
    fn, kw = REGIMES[regime]
    _, jds = getattr(jsyn, fn)(**kw)
    _, tds = getattr(tsyn, fn)(**kw)
    for split in ("train", "val", "test"):
        got = agg_for(tds[split], torch.device("cpu"))
        assert got == tds[split].suggested_agg == jds[split].suggested_agg
        assert agg_for(tds[split], "cpu", dtype="bfloat16") == got


@pytest.mark.parametrize("P, fill", [(128, 0.2), (512, 0.34), (512, 0.5),
                                     (500, 0.2)])
def test_split_geometry_follows_the_jax_rule(P, fill):
    """Where JAX's rule picks sized (P a multiple of 128, fill below 0.35)
    and where it does not: a SplitGeometry and `agg_for` on the CPU give
    what the JAX package's property gives for the same P and fill."""
    geo = _geometry(P, 3.0, fill)
    want = jpipeline.MetaDataset.suggested_agg.fget(
        types.SimpleNamespace(P_spt=P, P_qry=P, mean_bin_fill=fill))
    assert geo.suggested_agg == want
    assert agg_for(geo, torch.device("cpu")) == want


@pytest.mark.parametrize("recipe", sorted(PRESETS))
def test_auto_on_the_card_picks_sized_at_the_records(recipe):
    """At each run of record's geometry (bench.py replays it), at its
    preset's widths and dtype, the card's rule picks sized: its real edges
    per slot lie below the crossover. A torch.device needs no card."""
    rec = bench._load_parity(recipe)
    geo = bench.record_geometry(rec)
    cfg = PRESETS[recipe]
    dtype = rec["preset_overrides"].get("dtype", cfg.dtype)
    spec = build_model_config(cfg, bench.REPLICA_META[recipe]["feat"],
                              bench.REPLICA_META[recipe]["n_out"])
    P = max(geo.P_spt, geo.P_qry)
    assert edges_per_slot(geo) < card_crossover(
        P, aggregation_width(spec), dtype)
    assert agg_for(geo, torch.device("cuda"), spec, dtype) == "sized"
    assert agg_for(geo, torch.device("cuda", 0), spec, dtype) == "sized"
    assert agg_for(geo, torch.device("cpu"), spec, dtype) == "dense"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("P", [512, 1024])
def test_auto_on_the_card_turns_dense_past_the_crossover(P, dtype):
    """Half the crossover's edges per slot picks sized, twice it dense, at
    hidden 256 (the widest aggregation of any preset)."""
    cross = card_crossover(P, 256, dtype)
    assert agg_for(_geometry(P, 0.5 * cross), "cuda", None, dtype) == "sized"
    assert agg_for(_geometry(P, 2.0 * cross), "cuda", None, dtype) == "dense"


def test_auto_on_the_card_asks_no_multiple_of_128():
    """P = 500 (JAX's rule: dense whatever the fill) and a fill below 0.35:
    the card's rule reads the edges per slot only."""
    geo = _geometry(500, 2.0, fill=0.2)
    assert agg_for(geo, "cpu") == "dense"
    assert agg_for(geo, "cuda") == "sized"
    assert agg_for(_geometry(500, 4 * card_crossover(500, 256)),
                   "cuda") == "dense"


def test_card_crossover_interpolates_and_scales():
    """Between measured widths and capacities piecewise linear; past the
    widths flat; past the capacities in proportion to P."""
    table = CARD_CROSSOVER["float32"]
    assert card_crossover(512, 128) == table[512][128]
    assert card_crossover(1024, 300) == table[1024][256]
    mid = card_crossover(512, 89)
    assert min(table[512][50], table[512][128]) <= mid <= max(
        table[512][50], table[512][128])
    assert card_crossover(768, 256) == pytest.approx(
        (table[512][256] + table[1024][256]) / 2)
    assert card_crossover(256, 256) == pytest.approx(table[512][256] / 2)
    assert card_crossover(2048, 256) == pytest.approx(2 * table[1024][256])


def test_trainer_on_the_cpu_resolves_auto_by_the_jax_rule(capsys):
    """A Trainer on the CPU with agg="auto" runs the JAX package's choice
    for its train split and says which rule decided."""
    fn, kw = REGIMES["disjoint"]
    _, jds = getattr(jsyn, fn)(**kw)
    store, ds = getattr(tsyn, fn)(**kw)
    cfg = Config(n_way=3, k_spt=3, k_qry=4, h=2, hidden_dim=8, task_num=2,
                 update_step=1, update_step_test=1, agg="auto")
    tr = Trainer(cfg, store, ds, labels_num=3, device="cpu")
    assert tr.agg == jds["train"].suggested_agg == "dense"
    out = capsys.readouterr().out
    assert f"agg kernel: {tr.agg} by the JAX package's rule" in out
