"""The models a layer spec can name: models/gcn.py (GraphConv layers, the
default) and models/gat.py (GATConv layers). Each gives `init_params`,
`precompute` and `forward` with the same signatures."""

from gmeta_tpu_torch.models import gat, gcn


def module_for(layer_spec):
    """The model module of a layer spec (config.py `build_model_config`)."""
    return gat if layer_spec[0][0] == "GATConv" else gcn
