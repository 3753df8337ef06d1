"""Typed configuration with per-dataset presets.

Mirrors the reference's argparse flags (G-Meta/train.py:152-177), 21 live
ones and 4 dead ones dropped (MIGRATION.md), as a typed dataclass, fixing
its string-boolean quirks (`--task_mode True`, `--link_pred_mode True` as
*strings*, G-Meta/train.py:50,74) while keeping the same semantics. The
five presets reproduce the README recipes (G-Meta/README.md:66-179).

The fields, defaults and presets are those of the JAX package's config, so a
flag means the same thing to both packages; every field's feature runs in
the port. The port alone adds the last fields: `arch` picks the
architecture, G-Meta's GCN (the JAX package's only one) or the GAT of
models/gat.py, whose widths follow.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Config:
    # --- task / episode structure (reference defaults: train.py:153-177) ---
    data_dir: str = ""
    task_setup: str = "Disjoint"        # 'Disjoint' | 'Shared'
    link_pred_mode: bool = False
    task_mode: bool = False             # Tissue-PPI: data under root/task{task_n}/
    task_n: int = 1
    n_way: int = 3
    k_spt: int = 3
    k_qry: int = 24
    h: int = 2                          # hop count; also sets GCN depth (train.py:69-70)
    sample_nodes: int = 1000            # subgraph node cap (train.py:177)
    batchsz: int = 1000                 # number of pre-sampled train tasks
    eval_batchsz: int = 100             # val/test tasks (train.py:90-91 hardcodes 100)

    # --- optimisation ---
    epoch: int = 10
    task_num: int = 8                   # meta batch size
    meta_lr: float = 1e-3
    update_lr: float = 1e-3
    update_step: int = 5
    update_step_test: int = 10
    first_order: bool = True            # reference never sets create_graph (meta.py:125,149)

    # --- model ---
    input_dim: int = 0                  # 0 = derive from features at load,
                                        # mirroring train.py:67; a nonzero
                                        # value must match the data
    hidden_dim: int = 64

    # --- runtime ---
    seed: int = 222                     # reference seeds torch/np at 222 (train.py:33-35)
    dtype: str = "float32"              # compute dtype for activations
    train_result_report_steps: int = 30
    num_workers: int = 0                # host pipeline prefetch threads
    device_task_pool: bool = False      # pack the train pool once: compact
                                        # and resident on the device, or
                                        # host-windowed above the budget
    compact_pool_hbm_gb: float = 10.0   # device budget of the compact pool
                                        # (read only with device_task_pool;
                                        # the JAX package's default). On an
                                        # NVIDIA H100 80GB HBM3 it binds no
                                        # preset: the largest compact pools
                                        # are tree_of_life's 6.37 GB and
                                        # arxiv's 5.71 GB (task_pool records,
                                        # parity_torch/*.metrics.jsonl)
    task_vmap_chunk: int = -1           # tasks per chunk of the meta-step:
                                        # bounds the live densified
                                        # adjacencies. -1 = auto (all tasks
                                        # at once in this port), 0 = all
                                        # tasks at once, N > 0 = explicit
    host_pool_window: int = 8           # meta-steps per window of the
                                        # host-pool mode (read only with
                                        # device_task_pool)
    checkpoint_dir: str = ""            # empty = no checkpointing; resumes
                                        # from its newest checkpoint (either
                                        # package's)
    checkpoint_every_epochs: int = 1
    checkpoint_every_steps: int = 0     # 0 = epoch-granular only
    metrics_path: str = ""              # jsonl metrics stream; empty = stdout only
    remat_inner: bool = False           # recompute the inner step in the
                                        # backward
    track_train_curve: bool = True      # per-step query evals during training
                                        # (telemetry only, meta.py:129-157;
                                        # False trains identically)
    extractor: str = "auto"             # 'auto' | 'native' | 'numpy' host
                                        # extraction; 'auto' takes the C++
                                        # engine (csrc/extract.cpp) where
                                        # g++ builds it, else numpy
    extract_disk_cache: bool = True     # persist native-engine extractions
                                        # (native engine only)
    agg: str = "auto"                   # aggregation kernel: 'auto' picks per
                                        # train split (pipeline.agg_for: on
                                        # the card by its measured crossover
                                        # in real edges per slot, elsewhere
                                        # by the JAX package's bin-fill
                                        # rule); 'dense' = batched matmul;
                                        # 'sized' = the size-aware SpMM
                                        # kernels (ops/sized_spmm)
    cap_strategy: str = "uniform"       # subgraph node-cap: 'uniform' (reference
                                        # parity, subgraph_data_processing.py:312-314)
                                        # | 'degree' (centrality-scored keep-top-k)
    profile_dir: str = ""               # torch.profiler trace dir; empty = off
    profile_steps: int = 5              # steps to trace (starting after warm-up)
    debug_nans: bool = False            # anomaly detection: fail loudly at the
                                        # op that produced a NaN instead of the
                                        # (counted) NaN-skip guard

    # --- architecture (the port only; the JAX package runs the GCN) ---
    arch: str = "gcn"                   # 'gcn': G-Meta's GCN (models/
                                        # gcn.py, depth h); 'gat':
                                        # models/gat.py, three GAT layers
                                        # (Velickovic et al.'s PPI widths
                                        # by default); validate() refuses
                                        # any other name
    gat_heads: int = 4                  # heads of GAT layers 1 and 2
    gat_hidden: int = 256               # features a head there (concatenated)
    gat_out_heads: int = 6              # heads of GAT layer 3 (averaged)
    gat_out_dim: int = 121              # features a head there: the embedding

    @property
    def labels_num(self) -> int:
        raise RuntimeError("labels_num is dataset-dependent; use build_model_config")

    def validate(self, mesh_tasks: int = 0, mesh_edges: int = 0) -> "Config":
        """Checks the fields; `mesh_tasks` and `mesh_edges` are the run's
        task-DP and edge-engine ranks (run/train.py's flags), which a GAT
        refuses."""
        assert self.task_setup in ("Disjoint", "Shared"), self.task_setup
        if self.task_setup == "Shared" and self.n_way != Config.n_way:
            import warnings
            warnings.warn(
                "n_way is ignored in the Shared setup: every class of the "
                "sampled graph is used (subgraph_data_processing.py:198-217)",
                stacklevel=2)
        assert self.h in (1, 2, 3), "h must be 1, 2 or 3 (reference supports only these)"
        assert self.k_spt >= 1 and self.k_qry >= 1 and self.n_way >= 2
        assert self.cap_strategy in ("uniform", "degree"), self.cap_strategy
        assert self.agg in ("auto", "dense", "sized"), self.agg
        assert self.update_step >= 1 and self.update_step_test >= 1
        if self.link_pred_mode:
            assert self.task_setup == "Shared", "link prediction uses the Shared setup"
        if self.arch not in ("gcn", "gat"):
            raise ValueError(f"arch {self.arch!r} is no architecture of the "
                             f"port: 'gcn' or 'gat'")
        if self.arch == "gat":
            missing = [what for refused, what in (
                (self.agg == "dense", "a dense aggregation (agg='dense'): "
                 "the attention runs on the CSR path only"),
                (self.dtype != "float32", f"dtype {self.dtype!r}: its "
                 "kernels are float32 only"),
                (self.link_pred_mode, "link prediction: it has a node head "
                 "only"),
                (not self.first_order, "second-order MAML: the attention's "
                 "backward is first order"),
                (mesh_edges > 0, "the edge engine (--mesh_edges)"),
                (mesh_tasks > 0, "task-DP (--mesh_tasks)")) if refused]
            if missing:
                raise ValueError("arch='gat' has no " + "; no ".join(missing))
            assert min(self.gat_heads, self.gat_hidden, self.gat_out_heads,
                       self.gat_out_dim) >= 1
        return self


def build_model_config(cfg: Config, input_dim: int, labels_num: int):
    """Synthesise the layer spec exactly like the reference (train.py:67-75):
    h GraphConv layers (depth tied to hop count) then a Linear head; LinkPred
    doubles the head's input via endpoint-pair concat (learner.py:85,165-168).
    With arch='gat', the three ("GATConv", (fan_in, heads, width, concat,
    skip)) layers of models/gat.py then the Linear head. `cfg` may be the
    JAX package's Config, which has no `arch`: a GCN.
    """
    if getattr(cfg, "arch", "gcn") == "gat":
        K, F = cfg.gat_heads, cfg.gat_hidden
        return (("GATConv", (input_dim, K, F, True, False)),
                ("GATConv", (K * F, K, F, True, True)),
                ("GATConv", (K * F, cfg.gat_out_heads, cfg.gat_out_dim,
                             False, False)),
                ("Linear", (cfg.gat_out_dim, labels_num)))
    layers = [("GraphConv", (input_dim, cfg.hidden_dim))]
    for _ in range(cfg.h - 1):
        layers.append(("GraphConv", (cfg.hidden_dim, cfg.hidden_dim)))
    layers.append(("Linear", (cfg.hidden_dim, labels_num)))
    if cfg.link_pred_mode:
        layers.append(("LinkPred", (True,)))
    return tuple(layers)


# The five README recipes (G-Meta/README.md:66-179). `h` defaults to 2 everywhere
# (none of the recipes overrides it).
PRESETS = {
    "arxiv": Config(
        task_setup="Disjoint", n_way=3, k_spt=3, k_qry=24, h=2,
        epoch=10, task_num=32, batchsz=10000, hidden_dim=256,
        update_lr=0.01, meta_lr=1e-3, update_step=10, update_step_test=20,
        train_result_report_steps=200,
    ),
    "tissue_ppi": Config(
        task_setup="Shared", task_mode=True, task_n=4, k_spt=3, k_qry=10, h=2,
        epoch=15, task_num=4, batchsz=1000, hidden_dim=128,
        update_lr=0.01, meta_lr=5e-3, update_step=10, update_step_test=10,
        train_result_report_steps=200,
    ),
    "fold_ppi": Config(
        task_setup="Disjoint", n_way=3, k_spt=3, k_qry=24, h=2,
        epoch=5, task_num=16, batchsz=4000, hidden_dim=128,
        update_lr=0.005, meta_lr=1e-3, update_step=5, update_step_test=20,
        train_result_report_steps=100,
    ),
    "firstmm_db": Config(
        task_setup="Shared", link_pred_mode=True, n_way=2, k_spt=16, k_qry=32, h=2,
        epoch=15, task_num=8, batchsz=1500, hidden_dim=128,
        update_lr=0.01, meta_lr=5e-4, update_step=10, update_step_test=20,
        train_result_report_steps=200,
    ),
    "tree_of_life": Config(
        task_setup="Shared", link_pred_mode=True, n_way=2, k_spt=16, k_qry=16, h=2,
        epoch=15, task_num=8, batchsz=5000, hidden_dim=256,
        update_lr=0.005, meta_lr=5e-4, update_step=10, update_step_test=20,
        train_result_report_steps=200,
    ),
}
