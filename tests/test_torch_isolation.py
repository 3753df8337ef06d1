"""The port stands alone: neither gmeta_tpu_torch nor its GPU scripts
(chip_smoke.py, sweep_sized_spmm.py) import jax, optax or the JAX package,
and a port train step leaves them unloaded."""

import ast
import os
import subprocess
import sys
from pathlib import Path

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
    files += [ROOT / "chip_smoke.py", ROOT / "sweep_sized_spmm.py"]
    assert len(files) > 15
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


def test_train_step_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", STEP], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout, r.stdout
