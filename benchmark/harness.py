"""One run of a cell: the program set up from the seed, its first three
meta-steps recorded for the comparison, the measured (or traced) window,
then the plain reference of the cell's model (`cell.load_model`) over the
same three steps.

The program is driven as its Trainer drives a resident compact pool
(`run/train.py` `_fit_device_pool`): `MetaLearner.train_steps_from_compact`
over the epoch's shuffled task rows, one call of K meta-steps at a time,
each ending in the host's fetch of its metrics (the sync), with K the
Trainer's report cadence. The first three meta-steps go through that same
call on the same object before the window starts: they warm every shape the
window runs, and the state they leave is what the comparison reads.
"""

from __future__ import annotations

import dataclasses
import time
import types
from contextlib import contextmanager

import numpy as np
import torch

from benchmark import correct, generate
from benchmark.cell import Cell, load_metric
from benchmark.counts.model import set_shapes
from benchmark.trace import Trace

CHECK_STEPS = 3
TRACE_SECONDS = 4.0     # the traced window: whole calls until this long
REPORT_BYTES = 5e8      # the Trainer's cap on a report window's batches


def _sync(device):
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(cfg: dict):
    """The program's Config with the configuration's fields."""
    from gmeta_tpu_torch.config import Config
    names = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in cfg.items() if k in names}).validate()


def report_steps(cfg: dict, spt: dict, qry: dict) -> int:
    """Meta-steps per call: the Trainer's report window for a resident
    pool, its report cadence capped so that a window's full-form batches
    stay under REPORT_BYTES."""
    task_bytes = sum(v[0].nbytes for s in (spt, qry) for v in s.values())
    cap = int(REPORT_BYTES // max(task_bytes * cfg["task_num"], 1))
    return max(1, min(cfg["train_result_report_steps"],
                      cfg["batchsz"] // cfg["task_num"], cap))


def inputs(cell: Cell, seed: int, device, n_tasks: int):
    """(theta0 of the cell's model, feature table as numpy, support and
    query pool, the task order, the first CHECK_STEPS steps' rows, their
    tasks) from the seed. Only theta depends on the model."""
    cfg = cell.cfg
    theta0 = cell.model.make_theta(cfg, seed, device)
    feats = generate.make_features(cfg, seed, device).cpu().numpy()
    spt, qry = generate.make_pool(cfg, n_tasks, seed, device)
    order = generate.task_order(n_tasks, cfg["task_num"], seed)
    first = [next(order) for _ in range(CHECK_STEPS)]
    checked = generate.take((spt, qry), np.concatenate(first))
    return theta0, feats, spt, qry, order, first, checked


def resolve_agg(cfg: dict, agg: str, device, spec) -> str:
    """The mix's aggregation, with "auto" resolved by the program's own
    rule (data/pipeline.py `agg_for`) as its Trainer resolves it."""
    if agg != "auto":
        return agg
    from gmeta_tpu_torch.data.pipeline import SplitGeometry, agg_for
    b, (s_spt, s_qry) = cfg["buckets"], set_shapes(cfg)
    geo = SplitGeometry(b["P_spt"], b["B_spt"], b["E_spt"], b["P_qry"],
                        b["B_qry"], b["E_qry"],
                        float(s_spt.edges + s_qry.edges),
                        cfg["mean_bin_fill"])
    return agg_for(geo, device, spec, cfg["dtype"])


def learner(cfg: dict, mix_agg: str, theta0, feats, spt, qry, device):
    """(the program's MetaLearner with theta0, the features and the pool
    resident in compact form, as its Trainer builds one; its agg)."""
    from gmeta_tpu_torch.config import build_model_config
    from gmeta_tpu_torch.data.pack import SubgraphSet, TaskBatch
    from gmeta_tpu_torch.meta.maml import MetaLearner

    pcfg = program_config(cfg)
    spec = build_model_config(pcfg, cfg["feat_dim"], cfg["labels_num"])
    agg = resolve_agg(cfg, mix_agg, device, spec)
    ml = MetaLearner(
        spec, cfg["labels_num"], update_lr=pcfg.update_lr,
        meta_lr=pcfg.meta_lr, update_step=pcfg.update_step,
        update_step_test=pcfg.update_step_test,
        first_order=pcfg.first_order,
        compute_dtype=getattr(torch, pcfg.dtype), remat=pcfg.remat_inner,
        seed=pcfg.seed, track_curve=pcfg.track_train_curve, agg=agg,
        task_chunk=0, device=device)
    ml.set_params(theta0)
    ml.set_features(feats)
    ml.set_task_pool_compact(TaskBatch(spt=SubgraphSet(**spt),
                                       qry=SubgraphSet(**qry)))
    return ml, agg


def first_steps(ml, first, marks=None) -> dict:
    """The first meta-steps through the window's own call, one and then
    the rest: the losses, the first gradient as Adam holds it (its first
    moment after one step is (1 - b1) g) and theta after them. `marks`
    receives the first step's seconds."""
    t0 = time.perf_counter()
    losses = [ml.train_steps_from_compact(np.stack(first[:1]))["meta_loss"]]
    grad1 = [m.detach().clone() / (1 - 0.9) for m in ml.opt_state.mu]
    if marks is not None:
        _sync(grad1[0].device)
        marks["step1_s"] = time.perf_counter() - t0
    losses.append(ml.train_steps_from_compact(np.stack(first[1:]))[
        "meta_loss"])
    return {"losses": torch.cat(losses).double().cpu().tolist(),
            "grad1": grad1, "theta": ml.snapshot()}


def reference_tasks(checked, T: int, keep: int = None):
    """The checked steps' tasks as the reference takes them: per step a
    list of (support, query) dicts; `keep` of each step's T tasks."""
    spt, qry = checked
    keep = T if keep is None else keep
    return [[({k: v[i * T + t] for k, v in spt.items()},
              {k: v[i * T + t] for k, v in qry.items()})
             for t in range(keep)] for i in range(CHECK_STEPS)]


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """Set up, measure and compare one run. Returns a dict with the
    end-to-end or per-layer metrics, the device readings, the comparison
    and, traced, the breakdown."""
    cfg, mix = cell.cfg, cell.traffic
    if mix["mode"] != "compact_pool":
        raise ValueError(f"traffic mode {mix['mode']!r} is not driven")
    device = torch.device(device)
    cuda = device.type == "cuda"
    T = cfg["task_num"]
    marks = {}

    t0 = time.perf_counter()
    theta0, feats, spt, qry, order, first, checked = inputs(
        cell, seed, device, cfg["batchsz"])
    K = report_steps(cfg, spt, qry)
    marks["inputs_s"] = time.perf_counter() - t0

    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    ml, agg = learner(cfg, mix["agg"], theta0, feats, spt, qry, device)
    del spt, qry, feats
    _sync(device)
    marks["pool_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    prog = first_steps(ml, first, marks)
    _sync(device)
    marks["first_steps_s"] = time.perf_counter() - t0

    # -- the window ----------------------------------------------------------
    host = []

    @contextmanager
    def span(name):
        t = time.time_ns()
        yield
        if trace:
            host.append((t, time.time_ns(), name))

    prof = None
    if trace and cuda:
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
    length = min(seconds, TRACE_SECONDS) if trace else seconds
    steps = nan_steps = 0
    t_window, t_ns = time.perf_counter(), time.time_ns()
    while True:
        rows = np.stack([next(order) for _ in range(K)])
        with span("dispatch"):
            m = ml.train_steps_from_compact(rows)
        with span("sync"):
            m = {k: v.cpu() for k, v in m.items()}
        steps += K
        nan_steps += int(m["nan_skip"].sum())
        if time.perf_counter() - t_window >= length:
            break
    window_s = time.perf_counter() - t_window
    window_ns = (t_ns, time.time_ns())
    if prof is not None:
        prof.stop()
    setup_s = t_window - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    out = {"steps": steps, "tasks": steps * T, "failed": nan_steps * T,
           "window_s": window_s, "setup_s": setup_s, "peak_bytes": peak,
           "agg": agg, "steps_per_call": K, "marks": marks}
    if trace:
        tr = (Trace.from_profiler(prof, steps, window_ns, host)
              if prof is not None else Trace(window_ns, [], host, steps))
        del prof
        ctx = types.SimpleNamespace(trace=tr, cfg=cfg, model=cell.model,
                                    traffic=mix, agg=agg)
        per_layer = {}
        for m in cell.per_layer:
            value = load_metric(m["name"], cell.root).read(ctx)
            if value is not None:
                per_layer[m["name"]] = {"value": value, "unit": m["unit"]}
        out.update(per_layer=per_layer, busy_s=tr.busy_s,
                   traced_window_s=tr.window_s,
                   breakdown={"device_ops": tr.top_ops(),
                              "idle_gaps": tr.idle_gaps()})
    else:
        out["end_to_end"] = {
            "tasks_per_s": steps * T / window_s,
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s,
        }

    # -- the comparison, once the program's state is freed -----------------
    del ml
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    feats_dev = generate.make_features(cfg, seed, device)
    ref = cell.model.Reference(cfg).run(theta0, reference_tasks(checked, T),
                                        feats_dev)
    numbers = correct.readings(theta0, prog, ref)
    out["correct"], out["checks"] = correct.judge(numbers, cell.limits)
    out["readings"] = numbers
    out["reference_s"] = time.perf_counter() - t0
    log(f"# {cell.name}: agg {agg}, {K} steps a call, set-up "
        f"{setup_s:.2f} s {marks}, window {steps} steps in {window_s:.3f} "
        f"s, reference {out['reference_s']:.2f} s; readings {numbers}")
    return out
