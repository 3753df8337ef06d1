"""The port stands alone: neither gmeta_tpu_torch (its multi-rank modules,
replicas, parity runner, entry points, measurement scripts, replica
calibrators and benchmark included) nor its GPU scripts (chip_smoke.py,
sweep_sized_spmm.py, chip_ab.py) import jax, optax or the JAX package,
and neither a port train step, resuming from a
checkpoint the JAX package wrote, building datasets with the port's C++
engine, a spawned rank of a mesh, the parity runner's evaluation from a run
of record's checkpoint, a rank of `dryrun_multichip`, nor a replica
calibrator's main loads them (nor the JAX package's engine library)."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "optax", "gmeta_tpu")


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_imports_in_port_sources():
    files = sorted((ROOT / "gmeta_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "sweep_sized_spmm.py",
              ROOT / "chip_ab.py"]
    assert len(files) > 15
    names = {str(f.relative_to(ROOT)) for f in files}
    for module in ("mesh", "collectives", "dp", "launch", "edgepart",
                   "edgepart_train"):
        assert f"gmeta_tpu_torch/parallel/{module}.py" in names
    assert "gmeta_tpu_torch/run/edgepart.py" in names
    for module in ("data/replicas.py", "run/parity.py", "entry.py",
                   "bench.py", "scripts/bench_window.py",
                   "utils/cardtime.py", "scripts/common.py",
                   "scripts/bench_kernels.py", "scripts/bench_pallas_spmm.py",
                   "scripts/bench_transfer.py", "scripts/bench_edges.py",
                   "scripts/bench_edgepart.py", "scripts/calibrate_replicas.py",
                   "scripts/calibrate_fold.py", "scripts/calibrate_link.py"):
        assert f"gmeta_tpu_torch/{module}" in names
    bad = [(str(f.relative_to(ROOT)), m) for f in files
           for m in _imported_roots(f) if m in FORBIDDEN]
    assert not bad, bad


STEP = """
import sys
import torch
from gmeta_tpu_torch.config import Config, build_model_config
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.meta.maml import MetaLearner
store, ds = synthetic_disjoint(num_graphs=1, nodes_per_graph=150,
                               avg_degree=5, feat_dim=8, num_classes=9,
                               batchsz=4, sample_nodes=40, seed=1)
spec = build_model_config(Config(hidden_dim=8), store.feat_dim, 3)
ml = MetaLearner(spec, 3, update_lr=0.05, meta_lr=1e-3, update_step=2,
                 update_step_test=2, agg="sized", device="cpu")
ml.set_features(store.features)
m = ml.train_step(next(ds["train"].batches(2)))
assert torch.isfinite(m["meta_loss"])
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "optax", "gmeta_tpu"))
print("LOADED", loaded)
"""


def _run(code):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout


def test_train_step_loads_no_jax():
    _run(STEP)


RESUME = """
import sys
from gmeta_tpu_torch.config import Config
from gmeta_tpu_torch.data.synthetic import synthetic_disjoint
from gmeta_tpu_torch.run.train import Trainer
store, ds = synthetic_disjoint(num_graphs=1, nodes_per_graph=150,
                               avg_degree=5, feat_dim=8, num_classes=9,
                               batchsz=4, sample_nodes=40, seed=1)
tr = Trainer(Config(hidden_dim=8, checkpoint_dir=sys.argv[1]), store, ds,
             labels_num=3, device="cpu")
assert (tr.start_epoch, tr.global_step) == (2, 9), tr.start_epoch
assert int(tr.learner.opt_state.count) == 9
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "optax", "gmeta_tpu"))
print("LOADED", loaded)
"""


def test_resume_of_a_jax_checkpoint_loads_no_jax(tmp_path):
    """The checkpoint reader maps optax's classes itself: restoring what
    the JAX package wrote imports neither optax, jax nor gmeta_tpu."""
    import jax
    import optax
    from gmeta_tpu.config import Config, build_model_config
    from gmeta_tpu.models.gcn import init_params
    from gmeta_tpu.utils import checkpoint as jckpt

    spec = build_model_config(Config(hidden_dim=8), 8, 3)
    params = init_params(jax.random.PRNGKey(0), spec)
    opt = optax.adam(1e-3).init(params)
    opt = (opt[0]._replace(count=opt[0].count + 9), opt[1])
    jckpt.save(str(tmp_path), 9, dict(
        params=params, opt_state=opt, best_params=params, max_acc=0.4,
        epoch=1, batch_in_epoch=-1, step=9))
    _run(RESUME.replace("sys.argv[1]", repr(str(tmp_path))))


NATIVE = """
import sys
from pathlib import Path
import numpy as np
from gmeta_tpu_torch.config import Config
from gmeta_tpu_torch.data import native
from gmeta_tpu_torch.data.graph import synthetic_store
from gmeta_tpu_torch.data.prepare import prepare_node_disjoint
from gmeta_tpu_torch.ops import cuda_build
from gmeta_tpu_torch.run.train import build_datasets
store, labels = synthetic_store(num_graphs=2, nodes_per_graph=150,
                                avg_degree=6, feat_dim=8, num_classes=9,
                                seed=0)
feats = [store.features[store.node_offsets[g]:store.node_offsets[g + 1]]
         for g in range(2)]
prepare_node_disjoint(sys.argv[1], store.graphs, feats, labels,
                      num_label_set=3)
_, ds, _ = build_datasets(Config(data_dir=sys.argv[1], n_way=3, k_spt=2,
                                 k_qry=3, sample_nodes=40, batchsz=8,
                                 eval_batchsz=4, extractor="native"))
assert isinstance(ds["train"].extractor, native.NativeSubgraphExtractor)
lib = Path(native._lib()._name).resolve()
assert lib.parent == cuda_build.BUILD_DIR.resolve(), lib
assert lib.name.startswith("extract-"), lib
maps = open("/proc/self/maps").read()
assert str(lib) in maps and "_native_extract" not in maps
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "optax", "gmeta_tpu"))
print("LOADED", loaded)
"""


def test_native_build_datasets_loads_no_jax(tmp_path):
    """build_datasets(extractor="native") runs the port's own engine, built
    under build/gmeta_tpu_torch/, and loads neither jax nor gmeta_tpu nor
    gmeta_tpu/data/_native_extract.so."""
    from gmeta_tpu_torch.data import native
    if not native.available():
        import pytest
        pytest.skip("g++ is absent: the port's native engine cannot be built")
    _run(NATIVE.replace("sys.argv[1]", repr(str(tmp_path / "ds"))))


def test_spawned_ranks_load_no_jax(tmp_path):
    """Two gloo ranks, each running a task-DP step and an edge-partitioned
    step (tests/torch_rank_worker.py), load no jax, optax or gmeta_tpu."""
    from torch_rank_worker import run_scenario
    outs = run_scenario("isolation", 2, tmp_path, timeout=180.0)
    for out in outs:
        assert out["loaded"].size == 0, out["loaded"]
        assert np.isfinite(out["loss"])


EVAL_FROM = """
import sys
from gmeta_tpu_torch.run import parity
out, = parity.main(["firstmm_db", "--eval_from", "parity/firstmm_db.ckpt",
                    "--device", "cpu", "--replicas", sys.argv[1],
                    "--out", sys.argv[2], "--batchsz", "8",
                    "--eval_batchsz", "2"])
assert list(out["passes"]) == ["dense", "sized"], out
assert out["n_test_tasks"] == 2 and not out["checked"], out
assert out["passes"]["sized"]["max_task_diff_vs_first_pass"] <= out["one_query"]
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "optax", "gmeta_tpu"))
print("LOADED", loaded)
"""


def test_eval_from_loads_no_jax(tmp_path):
    """The parity runner's --eval_from (a firstmm_db replica made by the
    port, a copy of the run of record's checkpoint, the dual final test
    on 2 tasks with dense and with sized aggregation) loads neither jax,
    optax nor gmeta_tpu."""
    _run(EVAL_FROM.replace("sys.argv[1]", repr(str(tmp_path / "rep")))
         .replace("sys.argv[2]", repr(str(tmp_path / "out"))))


def test_dryrun_ranks_load_no_jax():
    """Each rank of the entry points' dry run, a fresh interpreter, loads
    neither jax, optax nor gmeta_tpu."""
    from gmeta_tpu_torch.entry import dryrun_multichip
    out = dryrun_multichip(2, device="cpu", timeout=180.0)
    assert out["ranks"] == 2 and out["loaded"] == []


CALIBRATE = """
import sys
from gmeta_tpu_torch.scripts import calibrate_replicas
res = calibrate_replicas.main(["firstmm_db", "tree_of_life", "--device",
                               "cpu", "--out", sys.argv[1]])
assert res["recipes"]["tree_of_life"]["split_rows"] > 0, res
loaded = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "optax", "gmeta_tpu"))
print("LOADED", loaded)
"""


def test_calibrator_main_loads_no_jax(tmp_path):
    """calibrate_replicas' main (two recipes' proxies through the gather's
    plain version, split rows included) loads neither jax, optax nor
    gmeta_tpu."""
    _run(CALIBRATE.replace("sys.argv[1]", repr(str(tmp_path / "c.json"))))
