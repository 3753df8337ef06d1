"""The port's driver entry points (gmeta_tpu_torch.entry) against
__graft_entry__.py: `entry()`'s function at the JAX package's params, and
`dryrun_multichip(4)` over gloo ranks on the CPU."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from gmeta_tpu_torch import entry
from gmeta_tpu_torch.convert import params_from_jax

torch.set_num_threads(2)


def test_entry_equals_the_jax_entry():
    jfn, (jparams, jtask, jfeats) = jentry.entry()
    want = [float(x) for x in jax.jit(jfn)(jparams, jtask, jfeats)]
    fn, (params, task, feats) = entry.entry(device="cpu")
    assert feats.device.type == "cpu" and task.qry.node_gid.shape[0] == 1
    # the same episode: both packages build it bitwise equal
    np.testing.assert_array_equal(task.qry.node_gid[0].numpy(),
                                  np.asarray(jtask.qry.node_gid))
    np.testing.assert_array_equal(task.spt.labels[0].numpy(),
                                  np.asarray(jtask.spt.labels))
    got = [float(x) for x in fn(params_from_jax(
        [np.asarray(p) for p in jparams]), task, feats)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the port's own init draws other numbers, through the same function
    loss, acc = fn(params, task, feats)
    assert np.isfinite(loss.item()) and 0.0 <= acc.item() <= 1.0


def test_entry_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()


def test_rank_plan_puts_shared_card_ranks_on_one_indexed_card():
    cuda = torch.device("cuda")
    assert entry.rank_plan(cuda, 4, 1) == ("cuda:0", "gloo")
    assert entry.rank_plan(torch.device("cuda", 0), 4, 1) == ("cuda:0", "gloo")
    assert entry.rank_plan(cuda, 4, 4) == ("cuda", "nccl")
    assert entry.rank_plan(torch.device("cpu"), 4, 0) == ("cpu", "gloo")


def test_dryrun_multichip_on_four_gloo_ranks():
    out = entry.dryrun_multichip(4, device="cpu", timeout=240.0)
    assert out["backend"] == "gloo" and out["device"] == "cpu"
    assert len(out["accs"]) == 3 and np.isfinite(out["meta_loss"])
    assert out["embed_shape"] == [200, 16]
    assert out["embed_max_diff"] <= 1e-4
    assert out["edgepart_mesh"] == [2, 2]
    assert out["edgepart_curves_shape"] == [4, 3]
    assert np.isfinite(out["edgepart_loss"])
    # on the CPU every gather runs its plain version: no kernel launched
    assert not any(v for c in out["launches"].values() for v in c.values())
    assert out["loaded"] == []
