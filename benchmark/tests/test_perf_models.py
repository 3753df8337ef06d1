"""The GCN's model file binds the pieces that the benchmark used before
models were found by name, and they give the values they gave then: theta,
the counts of both configurations and a tiny reference run, pinned."""

import hashlib
import json

import pytest
import torch

from benchmark import generate
from benchmark.cell import ROOT, load_model
from benchmark.counts import model as counts
from benchmark.reference import protomaml
from conftest import TINY

# Recorded on the tree before `cell.load_model` existed, with the pieces
# imported directly, on the CPU.
THETA_SHA256 = {
    "tiny_node": "90f82d927232a609ba8e58c6daa8bfe7"
                 "f3d7804ca51f4e79eff9b7a0996d65c1",
    "tiny_link": "a083852a5e878f4168662644621fa23a"
                 "7646b1431aa7bb110013c96942f2ab5b",
}
COUNTS = {   # step_flops, aggregation_bound_ms at 4 and at 2 bytes
    "arxiv": (2679190020096.0, 10.284096028656716, 5.184343718208955),
    "tree_of_life": (572609243792.0, 1.9762209050746269,
                     1.0100326782089553),
}
REFERENCE = {   # tiny_node, seed 7, two steps of four tasks
    "losses": [1.065181016921997, 1.199402928352356],
    "grad1": "5280d61759dc7067138e75bb57930a46"
             "f5e732e0e998a8ceb0b6e9d0a8637c5e",
    "theta": "755b18e3edafb9759e23ab8ea4d5c301"
             "35447afec944dc534e9bbf902bbf3562",
}


def _sha256(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def gcn():
    return load_model({})


def test_a_configuration_without_a_model_key_is_the_gcn(gcn):
    cfg = json.loads((ROOT / "benchmark/configs/arxiv.json").read_text())
    assert "model" not in cfg
    assert load_model(cfg).__file__ == gcn.__file__
    assert gcn.__file__ == str(ROOT / "benchmark/models/gcn.py")
    assert gcn.make_theta is generate.make_theta
    assert gcn.Reference is protomaml.Reference
    assert gcn.step_flops is counts.step_flops
    assert gcn.aggregation_bound_ms is counts.aggregation_bound_ms


@pytest.mark.parametrize("name", sorted(THETA_SHA256))
def test_theta_is_pinned(gcn, name):
    theta = gcn.make_theta(TINY[name], 7, torch.device("cpu"))
    assert _sha256(theta) == THETA_SHA256[name]


@pytest.mark.parametrize("name", sorted(COUNTS))
def test_counts_are_pinned(gcn, name):
    cfg = json.loads((ROOT / f"benchmark/configs/{name}.json").read_text())
    flops, bound4, bound2 = COUNTS[name]
    assert gcn.step_flops(cfg) == flops
    assert gcn.aggregation_bound_ms(cfg) == bound4
    assert gcn.aggregation_bound_ms(cfg, itemsize=2) == bound2


def test_a_tiny_reference_run_is_pinned(gcn):
    cfg, dev = TINY["tiny_node"], torch.device("cpu")
    theta = gcn.make_theta(cfg, 7, dev)
    feats = generate.make_features(cfg, 7, dev)
    spt, qry = generate.make_pool(cfg, 8, 7, dev)
    T = cfg["task_num"]
    steps = [[({k: v[i * T + t] for k, v in spt.items()},
               {k: v[i * T + t] for k, v in qry.items()})
              for t in range(T)] for i in range(2)]
    r = gcn.Reference(cfg).run(theta, steps, feats)
    assert r["losses"] == REFERENCE["losses"]
    assert _sha256(r["grad1"]) == REFERENCE["grad1"]
    assert _sha256(r["theta"]) == REFERENCE["theta"]
