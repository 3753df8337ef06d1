"""The models a layer spec can name: models/gcn.py (GraphConv layers, the
default), models/gat.py (GATConv layers) and models/graphormer.py
(Graphormer layers). Each gives `init_params`, `precompute` and `forward`
with the same signatures."""

from gmeta_tpu_torch.models import gat, gcn, graphormer

# the models whose attention takes a repacked set's segments
SEGMENTED = (gat, graphormer)


def module_for(layer_spec):
    """The model module of a layer spec (config.py `build_model_config`)."""
    first = layer_spec[0][0]
    return {"GATConv": gat, "GraphormerEmbed": graphormer}.get(first, gcn)
