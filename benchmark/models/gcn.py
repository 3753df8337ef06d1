"""G-Meta's GCN (h GraphConv layers with the symmetric clamp-degree norm,
bias and ReLU, a centre readout, a Linear head; both endpoints joined under
link prediction), the model of every configuration without a `model` key.

Its pieces stay where they were written and are bound here by name, so
that the harness, the control and the metric readers find them through
`cell.load_model` as they find another model's file:

- `make_theta`: generate.py, the published initialisation from the seed;
- `Reference`: reference/protomaml.py, the plain first-order ProtoMAML
  step of this GCN;
- `step_flops`, `aggregation_bound_ms`: counts/model.py, the operations a
  meta-step requires and the bound of its `csr_gather_kernel` calls.
"""

from benchmark.counts.model import aggregation_bound_ms, step_flops
from benchmark.generate import make_theta
from benchmark.reference.protomaml import Reference

__all__ = ["make_theta", "Reference", "step_flops", "aggregation_bound_ms"]
