"""The port's replica calibrators (gmeta_tpu_torch/scripts/calibrate_*.py)
against the JAX package's (scripts/calibrate_*.py, loaded by path): the
A_hat^2 X aggregation at float32 and float64, the four proxies and the
recipes' table, the replicas of a knob byte for byte (for tree_of_life,
the generator's arguments), one probe row of the link sweep trained by
both runners from the JAX initial theta, and every CLI raising without
CUDA unless the CPU is named."""

import hashlib
import json
import sys
import time
import types
import zipfile
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from gmeta_tpu_torch.ops import sized_spmm as sp
from gmeta_tpu_torch.run import parity
from gmeta_tpu_torch.scripts import calibrate_fold as pfold
from gmeta_tpu_torch.scripts import calibrate_link as plink
from gmeta_tpu_torch.scripts import calibrate_replicas as prep

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import calibrate_fold as jfold  # noqa: E402
import calibrate_link as jlink  # noqa: E402
import calibrate_replicas as jrep  # noqa: E402
import run_parity  # noqa: E402

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, 1e-5), "float64": (torch.float64, 1e-12)}

# zipfile stamps each member with the wall clock; pinned, so that two
# writes of the same arrays are the same bytes
_FIXED_TIME = types.SimpleNamespace(time=lambda: 1.7e9,
                                    localtime=time.localtime)


def _digests(d):
    return {str(p.relative_to(d)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(Path(d).rglob("*")) if p.is_file()}


def _graph_with_hub_and_duplicates(n=600, seed=0):
    """A ring, a hub (node 5) joined to 300 others, and 40 pairs repeated."""
    rng = np.random.RandomState(seed)
    i = np.arange(n)
    ring = np.stack([i, (i + 1) % n], 1)
    hub = np.stack([np.full(300, 5), rng.choice(np.delete(i, 5), 300,
                                                replace=False)], 1)
    pairs = np.concatenate([ring, hub])
    pairs = np.concatenate([pairs, pairs[rng.randint(0, len(pairs), 40)]])
    return pairs, rng.randn(n, 7).astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_agg_hops_matches_jax(dtype):
    torch_dtype, rtol = DTYPES[dtype]
    pairs, X = _graph_with_hub_and_duplicates()
    assert len(np.unique(pairs, axis=0)) < len(pairs)
    n = X.shape[0]
    want = jrep.agg_hops(pairs, n, X, 2)
    prep.reset_hop_stats()
    got = prep.agg_hops(pairs, n, X, 2, device="cpu", dtype=torch_dtype)
    assert got.dtype == np.float64 and got.shape == want.shape
    assert prep.hop_stats == {"graphs": 1, "edges": 2 * len(pairs),
                              "split_rows": 1}
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_agg_hops_defaults_to_the_card():
    pairs, X = _graph_with_hub_and_duplicates()
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        prep.agg_hops(pairs, X.shape[0], X)


def test_csr_gather_takes_float64_on_the_cpu_only():
    pair = sp.csr_pair([0, 1, 1], [1, 0, 0], 2, 2)
    x = torch.tensor([[1.0 + 2.0**-40], [3.0]], dtype=torch.float64)
    out = sp.csr_gather(pair.row_ptr, pair.col, x)
    assert out.dtype == torch.float64
    assert out[:, 0].tolist() == [6.0, 1.0 + 2.0**-40]
    with pytest.raises(TypeError, match="float64 on the CPU"):
        sp.csr_gather(pair.row_ptr, pair.col, x.half())


# small sizes of each proxy, the JAX script's keyword names
SMALL = {
    "node": ("proxy_node", dict(
        n=1_500, feat_dim=32, classes=10, n_way=3, k_spt=3, k_qry=24,
        local_k=5, hub_deg=3.6, hub_alpha=0.85, noise=0.5, signal=0.3,
        episodes=100, rank=4)),
    "tissue": ("proxy_tissue", dict(
        n=1_500, feat_dim=20, local_k=10, hub_deg=8.0, base_win=24,
        feat_noise=0.6, spike_dim=2, spike=3.0, episodes=100)),
    "fold": ("proxy_fold", dict(
        n_graphs=3, n=600, feat_dim=64, classes=12, local_k=4, hub_deg=4.0,
        hub_alpha=0.8, noise=0.5, signal=0.3, assort=0.5, episodes=100,
        rank=4)),
    "link": ("proxy_link", dict(
        n=1_500, feat_dim=5, local_k=1, hub_deg=4.0,
        feature_kind="structural", noise=0.3, beta=3.0, z_win=32,
        episodes=100)),
}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("proxy", sorted(SMALL))
def test_proxy_matches_jax(proxy, dtype):
    fname, kw = SMALL[proxy]
    want = getattr(jrep, fname)(**kw)
    got = getattr(prep, fname)(**kw, device="cpu",
                               dtype=DTYPES[dtype][0])
    tol = 1e-12 if dtype == "float64" else 0.002
    assert got == pytest.approx(want, abs=tol)
    assert 0.3 < got[0] < 1.0 and 0.3 < got[1] < 1.0


@pytest.mark.parametrize("name", sorted(jrep.RECIPE_PROXIES))
def test_recipe_proxies_match_jax(name):
    """The same recipes and targets; JAX_CPU is the JAX script's output at
    full size, and the port's float32 CPU run lands within 0.002 of it."""
    assert list(prep.RECIPE_PROXIES) == list(jrep.RECIPE_PROXIES)
    assert prep.RECIPE_PROXIES[name][1] == jrep.RECIPE_PROXIES[name][1]
    want = jrep.RECIPE_PROXIES[name][0]()
    assert tuple(map(float, want)) == prep.JAX_CPU[name]
    got = prep.RECIPE_PROXIES[name][0](device="cpu")
    assert got == pytest.approx(want, abs=0.002)


def test_calibrate_replicas_main_on_the_cpu(tmp_path):
    out = tmp_path / "cal.json"
    res = prep.main(["firstmm_db", "--device", "cpu", "--out", str(out)])
    row = res["recipes"]["firstmm_db"]
    assert (row["proto"], row["lda"]) == prep.JAX_CPU["firstmm_db"]
    assert row["graphs"] == 1 and row["split_rows"] == 0
    assert res["launches"] == {"csr_gather": 0, "combine": 0}
    assert json.loads(out.read_text())["recipes"]["firstmm_db"] == row


def _stub_runner(calls):
    """A run_recipe that writes one val record and returns fixed
    accuracies, recording the arguments it was given."""
    def run_recipe(name, args):
        calls.append((name, args))
        Path(args.out).mkdir(parents=True, exist_ok=True)
        (Path(args.out) / f"{name}.metrics.jsonl").write_text(
            json.dumps({"kind": "val", "acc_curve": [0.5, 0.61234]}) + "\n")
        return {"acc": {"test_acc_final_step": 0.6, "best_model_acc": 0.61,
                        "early_stopped_ref_style": 0.62,
                        "test_acc_ref_style": 0.55}}
    return run_recipe


PROBES = {
    "fold": (lambda mod, out: mod.probe_once(
        0.38, str(out), keep_replica=True, noise=0.35, assort=0.7,
        private=0.3, full=True, rank=3), "s0.380_p0.30_r3_n0.35_a0.70"),
    "link": (lambda mod, out: mod.probe_once(
        "firstmm_db", 0.22, 3.0, str(out), keep_replica=True),
        "firstmm_db_n0.22_b3.00"),
}


@pytest.mark.parametrize("kind", sorted(PROBES))
def test_probe_replica_byte_identical(tmp_path, kind):
    """probe_once at a knob other than the defaults writes the JAX
    script's replica, byte for byte, and hands the runner the JAX
    script's arguments plus the JAX init and the device."""
    probe, tag = PROBES[kind]
    jcalls, pcalls = [], []
    with mock.patch.object(zipfile, "time", _FIXED_TIME), \
            mock.patch.object(run_parity, "run_recipe",
                              _stub_runner(jcalls)), \
            mock.patch.object(parity, "run_recipe", _stub_runner(pcalls)):
        want_res = probe(jfold if kind == "fold" else jlink,
                         tmp_path / "jax")
        got_res = probe(pfold if kind == "fold" else plink,
                        tmp_path / "port")
    assert got_res == want_res
    got, want = _digests(tmp_path / "port" / tag), _digests(
        tmp_path / "jax" / tag)
    assert len(got) >= 5 and got == want
    (jname, jargs), = jcalls
    (pname, pargs), = pcalls
    assert jname == pname
    extra = {"init_from_jax": True, "device": None}
    paths = ("replicas", "out")
    assert ({k: v for k, v in vars(pargs).items() if k not in paths}
            == {**{k: v for k, v in vars(jargs).items() if k not in paths},
                **extra})
    for k in paths:
        assert (Path(getattr(pargs, k)).relative_to(tmp_path / "port")
                == Path(getattr(jargs, k)).relative_to(tmp_path / "jax"))


@pytest.mark.parametrize("recipe", sorted(jlink.TARGETS))
def test_link_probe_recipe_arguments_match_jax(tmp_path, recipe):
    """Each link recipe's probe hands `_link_recipe` the JAX script's
    arguments (the full tree_of_life replica is too large to write here
    twice, so its bytes are not compared)."""
    seen = {"jax": [], "port": []}

    def recorder(which):
        def _link_recipe(out, **kw):
            seen[which].append((Path(out).relative_to(tmp_path / which),
                                kw))
        return _link_recipe
    with mock.patch.object(jlink.make_replicas, "_link_recipe",
                           recorder("jax")), \
            mock.patch.object(plink.replicas, "_link_recipe",
                              recorder("port")), \
            mock.patch.object(run_parity, "run_recipe", _stub_runner([])), \
            mock.patch.object(parity, "run_recipe", _stub_runner([])):
        for which, mod in (("jax", jlink), ("port", plink)):
            mod.probe_once(recipe, 0.4, 2.0, str(tmp_path / which))
    assert seen["port"] == seen["jax"] and len(seen["jax"]) == 1
    assert seen["jax"][0][1]["noise"] == 0.4
    assert seen["jax"][0][1]["beta"] == 2.0


def _cut(run_recipe):
    """The runner at one epoch of one meta-batch and 4 val/test tasks."""
    def run(name, args):
        args.epoch, args.batchsz, args.eval_batchsz = 1, 8, 4
        return run_recipe(name, args)
    return run


@pytest.fixture
def jax_cache_restored():
    """The JAX runner points jax's compilation cache into the repository;
    set back after the test."""
    import jax
    old = (jax.config.jax_compilation_cache_dir,
           jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", old[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old[1])


def test_link_probe_row_matches_jax(tmp_path, jax_cache_restored):
    """calibrate_link firstmm_db, one probe row (noise 0.30, beta 3.5),
    both runners cut to one meta-batch of 8 tasks and 4 val/test tasks:
    the JAX script on the JAX runner and the port's on the CPU, both from
    the JAX initial theta, agree within one query per task, with the same
    row keys and sweep file."""
    argv = ["firstmm_db", "--noises", "0.30", "--betas", "3.5", "--probe"]
    with mock.patch.object(run_parity, "run_recipe",
                           _cut(run_parity.run_recipe)), \
            mock.patch.object(sys, "argv", ["calibrate_link"] + argv
                              + ["--out", str(tmp_path / "jax")]):
        jlink.main()
    with mock.patch.object(parity, "run_recipe", _cut(parity.run_recipe)):
        rows = plink.main(argv + ["--device", "cpu", "--out",
                                  str(tmp_path / "port")])
    want = json.loads((tmp_path / "jax" / "firstmm_db_sweep.json")
                      .read_text())
    got = json.loads((tmp_path / "port" / "firstmm_db_sweep.json")
                     .read_text())
    assert got["target"] == want["target"] and got["rows"] == rows
    (g,), (w,) = got["rows"], want["rows"]
    assert list(g) == list(w) == ["noise", "beta", "final", "best",
                                  "ref_style"]
    res = json.loads((tmp_path / "port" / "res_firstmm_db_n0.30_b3.50"
                      / "firstmm_db.json").read_text())
    assert res["init_from_jax"] and res["epochs"] == 1
    one_query = 1.0 / (2 * 32)
    for k in ("final", "best", "ref_style"):
        assert abs(g[k] - w[k]) <= one_query + 1e-6, (k, g, w)
    assert not (tmp_path / "port" / "firstmm_db_n0.30_b3.50"
                / "firstmm_db").exists()


CLIS = {
    "calibrate_replicas": (prep.main, ["firstmm_db"]),
    "calibrate_fold": (pfold.main, ["--signals", "0.4"]),
    "calibrate_link": (plink.main, ["firstmm_db", "--noises", "0.3"]),
}


@pytest.mark.parametrize("name", sorted(CLIS))
def test_cli_raises_without_cuda(tmp_path, name):
    main, argv = CLIS[name]
    with mock.patch.object(torch.cuda, "is_available", lambda: False), \
            pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv + ["--out", str(tmp_path / "out")])
    assert not (tmp_path / "out").exists()
