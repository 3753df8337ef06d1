"""The plain reference against a step worked by hand with dense matrices,
and its TF32 rounding."""

import math

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.reference.protomaml import Reference, round_tf32
from conftest import TINY


def hand_logits(w, s, X, link):
    """Dense: A[dst, src] counts each real edge; D^-1/2 A D^-1/2 with the
    in-degree clamped at 1; the published layer order and readout."""
    N = s["node_gid"].size
    A = torch.zeros(N, N, dtype=torch.float64)
    for a, b, m in zip(s["edge_src"], s["edge_dst"], s["edge_mask"]):
        if m:
            A[int(b), int(a)] += 1.0
    d = torch.diag(A.sum(1).clamp(min=1.0) ** -0.5)
    M = d @ A @ d
    h = X[torch.as_tensor(s["node_gid"].reshape(-1)).long()] \
        * torch.as_tensor(s["node_mask"].reshape(-1, 1), dtype=torch.float64)
    for li in range(2):
        h = torch.relu(M @ h @ w[2 * li] + w[2 * li + 1])
    c = torch.as_tensor(s["centers"]).long()
    z = torch.cat([h[c[:, 0]], h[c[:, 1]]], 1) if link else h[c[:, 0]]
    return z @ w[4].T + w[5]


def hand_loss(logits, y, protos):
    total = 0.0
    for i in range(len(y)):
        d = [((logits[i] - p) ** 2).sum() for p in protos]
        total = total + d[int(y[i])] + torch.log(sum(torch.exp(-x)
                                                     for x in d))
    return total / len(y)


def hand_protos(logits, y, C):
    return [sum(logits[i] for i in range(len(y)) if y[i] == c)
            / max(1, sum(1 for v in y if v == c)) for c in range(C)]


def hand_step(cfg, theta, tasks, X):
    """First-order ProtoMAML and one Adam step, written out."""
    link, C, lr = cfg["link_pred_mode"], cfg["labels_num"], cfg["update_lr"]
    grads, loss = [torch.zeros_like(p) for p in theta], 0.0
    for spt, qry in tasks:
        w = [p.clone() for p in theta]
        for k in range(cfg["update_step"]):
            w = [x.detach().requires_grad_() for x in w]
            out = hand_logits(w, spt, X, link)
            protos = hand_protos(out, spt["labels"], C)
            g = torch.autograd.grad(hand_loss(out, spt["labels"], protos), w,
                                    retain_graph=True)
            fast = [x - lr * gx.detach() for x, gx in zip(w, g)]
            if k < cfg["update_step"] - 1:
                w = fast
        meta = hand_loss(hand_logits(fast, qry, X, link), qry["labels"],
                         protos)
        loss = loss + float(meta.detach()) / len(tasks)
        grads = [a + b / len(tasks)
                 for a, b in zip(grads, torch.autograd.grad(meta, w))]
    new = []
    for p, g in zip(theta, grads):
        m, v = 0.1 * g / 0.1, 0.001 * g * g / 0.001
        new.append(p - cfg["meta_lr"] * m / (v.sqrt() + 1e-8))
    return loss, grads, new


@pytest.mark.parametrize("name", sorted(TINY))
def test_reference_step_equals_the_hand_step(name):
    cfg = dict(TINY[name], update_step=2)
    dev = torch.device("cpu")
    # biases off zero, so that no ReLU sits at its kink (an isolated node's
    # pre-activation is its bias), where two sums' rounding picks the side
    g = torch.Generator().manual_seed(0)
    theta = [p.double() + (0.1 * torch.randn(p.shape, generator=g,
                                              dtype=torch.float64)
                           if p.dim() == 1 else 0)
             for p in generate.make_theta(cfg, 3, dev)]
    X = generate.make_features(cfg, 3, dev).double()
    spt, qry = generate.make_pool(cfg, 2, 3, dev)
    tasks = [generate.take((spt, qry), [t]) for t in range(2)]
    tasks = [({k: v[0] for k, v in s.items()}, {k: v[0] for k, v in q.items()})
             for s, q in tasks]
    ref = Reference(cfg, dtype=torch.float64)
    loss, grad, new, adam = ref.step(
        theta, (0, [torch.zeros_like(p) for p in theta],
                [torch.zeros_like(p) for p in theta]), tasks, X)
    h_loss, h_grad, h_new = hand_step(cfg, theta, tasks, X)
    assert float(loss) == pytest.approx(h_loss, rel=1e-12)
    for a, b in zip(grad, h_grad):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-14)
    # the head's bias shifts logits and prototypes alike: its gradient is
    # nought to rounding, and Adam moves it by the rounding's sign
    for a, b in zip(new[:-1], h_new[:-1]):
        torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-14)
    assert float(h_grad[-1].abs().max()) < 1e-12
    assert adam[0] == 1


def test_a_non_finite_loss_skips_the_step():
    cfg = dict(TINY["tiny_node"], update_step=1)
    dev = torch.device("cpu")
    theta = [p.double() for p in generate.make_theta(cfg, 3, dev)]
    X = generate.make_features(cfg, 3, dev).double()
    X[:] = math.nan
    spt, qry = generate.take(generate.make_pool(cfg, 1, 3, dev), [0])
    task = ({k: v[0] for k, v in spt.items()},
            {k: v[0] for k, v in qry.items()})
    adam = (0, [torch.zeros_like(p) for p in theta],
            [torch.zeros_like(p) for p in theta])
    loss, _, new, adam2 = Reference(cfg, dtype=torch.float64).step(
        theta, adam, [task], X)
    assert not math.isfinite(float(loss))
    assert new is theta and adam2 is adam


def test_tf32_rounding():
    one = 1.0
    x = torch.tensor([one, one + 2**-11, one + 3 * 2**-11, one + 2**-10,
                      -(one + 3 * 2**-11), 3.0e-3], dtype=torch.float32)
    r = round_tf32(x)
    assert r[0] == 1 and r[1] == 1                    # a tie goes to even
    assert r[2] == one + 2**-9 and r[3] == one + 2**-10
    assert r[4] == -(one + 2**-9)
    m, e = np.frexp(r[5].item())
    assert (m * 2**11) == int(m * 2**11)             # 10 bits after the 1
    assert abs(r[5].item() - 3.0e-3) <= 3.0e-3 * 2**-11
