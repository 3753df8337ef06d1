"""Parameters between the JAX package and the port.

Both packages keep the classifier's parameters as one flat sequence
(W, b, W, b, ...) with the same shapes — GraphConv W as (in, out), Linear W
as (out, in) — so conversion is the identity on the values.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def params_from_jax(params: Sequence[np.ndarray], device="cpu"):
    """The JAX package's parameters (as numpy arrays, e.g.
    `[np.asarray(p) for p in learner.params]`) as float32 tensors on
    `device`, in the same order: for `MetaLearner.set_params` and, from the
    JAX edge-partitioned trainer's theta (the same flat spec),
    `EdgePartMetaTrainer.set_params`."""
    return tuple(torch.from_numpy(np.array(p, np.float32)).to(device)
                 for p in params)

