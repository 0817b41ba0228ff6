"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
of the port and record its analysis, allocating nothing.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
      [--shape NAME] [--mesh single|multi|both]
      [--out experiments/dryrun_torch]

Each cell is traced on rank 0 of a fake process group (``torch.distributed``'s
``fake`` backend) at the mesh's world size, 256 ranks for the 16 x 16 mesh
and 512 for 2 x 16 x 16, on the CPU in fake tensors (``FakeTensorMode``:
shapes and dtypes, no data), under ``rules_for(cfg, shape, mesh)`` and the
``--perf`` flags.  The params (and the train step's AdamW moments, and the
decode step's cache) are the rules' ``DTensor``s, each rank's shard of them
a fake tensor.  The step is the port's own: ``train.make_train_step`` for a
train cell, ``serve.make_prefill_step`` / ``make_decode_step`` on the rules'
shards for prefill and decode; ``core.hlo.analyze_step`` traces one call and
counts rank 0's FLOPs, bytes, collectives and memory.  Like the reference's
faked 512-device CPU host, this is the dry run by design: no real process
group starts, and no collective moves data.

Results are appended incrementally to <out>/results.json under the
reference's keys (``arch|shape|mesh``, then ``|mbN`` and ``|perf``), so the
sweep is resumable; cells already present are skipped unless --force.  A
record has the reference's fields; ``lower_s`` is the trace time and
``compile_s`` 0 (nothing is compiled), ``cost`` the analyzer's totals
under XLA's cost-analysis names.  The default --out is
``experiments/dryrun_torch``: ``experiments/dryrun`` is the reference's
sweep, which its tests read.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.core.config import (SHAPES, ModelConfig, ShapeConfig,
                                     cell_is_runnable)


# ---------------------------------------------------------------------------
# the fake world


@contextlib.contextmanager
def fake_world(world: int):
    """A fake process group of ``world`` ranks, this process rank 0, for
    the block: collectives are accepted and move nothing.  Destroyed on
    exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already running; the dry "
                           "run starts its own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


# ---------------------------------------------------------------------------
# abstract inputs (fake tensors, under the caller's FakeTensorMode)


def abstract_params(cfg: ModelConfig):
    """(params as fake tensors, the logical-axes tree); call under a
    ``FakeTensorMode``, so that nothing is allocated."""
    from repro_torch.models import transformer as T
    return T.init_params(cfg, 0, "cpu"), T.param_axes(cfg)


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int):
    """(the cache's leaves on the meta device: shapes and dtypes, the
    logical-axes tree)."""
    from repro_torch.models import transformer as T
    return T.init_cache(cfg, batch, max_seq, "meta"), \
        T.cache_axes(cfg, batch, max_seq)


def input_specs(cfg: ModelConfig, shape: ShapeConfig, rules):
    """The model inputs of this cell as fake tensors of the global batch
    (each step takes its shard by the rules' ``batch`` entry), for a
    train cell (tokens, labels, frames / patches), a prefill cell (tokens,
    frames / patches) or a decode cell (the cache as the rules' DTensors,
    and one token a sequence).  Call under a ``FakeTensorMode``."""
    import torch
    from repro_torch.serve import step as serve_step
    B, S = shape.global_batch, shape.seq_len

    def frontends(batch):
        if cfg.family == "encdec":
            batch["frames"] = torch.empty(B, cfg.encoder.n_ctx, cfg.d_model)
        if cfg.family == "vlm":
            batch["patches"] = torch.empty(B, cfg.n_patches, cfg.d_model)
        return batch

    if shape.kind == "train":
        return frontends({"tokens": torch.empty(B, S, dtype=torch.int32),
                          "labels": torch.empty(B, S, dtype=torch.int32)})
    if shape.kind == "prefill":
        return frontends({"tokens": torch.empty(B, S, dtype=torch.int32)})
    from repro_torch.models import transformer as T
    layout = serve_step._layout(cfg, rules, B, S)
    full, _ = abstract_cache(cfg, B, S)
    local = T.local_cache(cfg, B, S, layout, "cpu")
    cache = {k: serve_step._as_dtensor(v, rules, layout[k][1],
                                       tuple(full[k].shape))
             for k, v in local.items()}
    return cache, torch.empty(B, 1, dtype=torch.long)


# ---------------------------------------------------------------------------
# one cell


def _perf_flags(perf: str):
    from repro_torch.dist import context as dist_ctx
    kw = {}
    for item in filter(None, perf.split(",")):
        if "=" in item:
            k, v = item.split("=", 1)
            kw[k] = v
        else:
            kw[item] = True
    return dist_ctx.PerfFlags(**kw)


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               n_microbatches: int = 1, perf: str = ""):
    """Traces one cell: returns (``core.hlo.analyze_step``'s dict of rank
    0's step, the rules).  Installs the mesh, the rules and the flags for
    the call and clears them after; call inside ``fake_world`` with the
    mesh over it.  Raises on a failure."""
    from repro_torch.core.hlo import analyze_step
    from repro_torch.dist import context as dist_ctx
    from repro_torch.dist import sharding
    from repro_torch.serve import step as serve_step

    rules = sharding.rules_for(cfg, shape, mesh)
    sharding.set_active_rules(rules)
    dist_ctx.set_mesh(mesh)
    dist_ctx.set_perf_flags(_perf_flags(perf))
    try:
        with fake_mode():
            params, axes = abstract_params(cfg)
            if dist_ctx.model_size() > 1:
                params = sharding.distribute(
                    params, rules.tree_shardings(axes, params), mesh)
            if shape.kind == "train":
                from repro_torch.optim import adamw_init
                from repro_torch.train import TrainConfig, make_train_step
                step = make_train_step(cfg, TrainConfig(
                    n_microbatches=n_microbatches))
                opt = adamw_init(params)
                batch = input_specs(cfg, shape, rules)
                hlo = analyze_step(step, params, opt, batch, 1)
            elif shape.kind == "prefill":
                step = serve_step.make_prefill_step(cfg,
                                                    max_seq=shape.seq_len)
                hlo = analyze_step(step, params,
                                   input_specs(cfg, shape, rules))
            else:
                step = serve_step.make_decode_step(cfg)
                cache, tokens = input_specs(cfg, shape, rules)
                hlo = analyze_step(step, params, cache, tokens,
                                   shape.seq_len - 1)
    finally:
        sharding.set_active_rules(None)
        dist_ctx.set_mesh(None)
        dist_ctx.set_perf_flags(dist_ctx.PerfFlags())
    return hlo, rules


def run_cell(arch: str, shape: ShapeConfig, mesh, mesh_name: str,
             out_dir: Path, *, n_microbatches: int = 1, perf: str = "",
             smoke: bool = False):
    """Traces one cell; returns the result record (the reference's
    fields)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    runnable, why = cell_is_runnable(cfg, shape)
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name,
           "kind": shape.kind, "perf": perf, "timestamp": time.time()}
    if not runnable:
        rec.update(status="skip", reason=why)
        return rec
    t0 = time.time()
    try:
        hlo, _ = lower_cell(cfg, shape, mesh, n_microbatches=n_microbatches,
                            perf=perf)
        t_lower = time.time() - t0
        print(f"  traced in {t_lower:.1f}s", flush=True)
        memory = hlo.pop("memory")
        rec.update(
            status="ok", lower_s=round(t_lower, 2), compile_s=0.0,
            memory=memory,
            cost={"flops": hlo["flops"],
                  "transcendentals": hlo["transcendentals"],
                  "bytes accessed": hlo["bytes"]},
            hlo=hlo)
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return rec


# ---------------------------------------------------------------------------
# the sweep (resumable)


def load_results(path: Path):
    if path.exists():
        return json.loads(path.read_text())
    return {}


def _production(multi_pod):
    def make():
        from repro_torch.launch.mesh import make_production_mesh
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    return make


# {name: (world size, the mesh's maker, run inside the fake world)}
MESHES = {"pod16x16": (256, _production(False)),
          "pod2x16x16": (512, _production(True))}


def sweep(archs, shapes, meshes, out_dir: Path, *, force: bool = False,
          n_microbatches: int = 1, perf: str = "", smoke: bool = False):
    """Every (mesh, arch, shape) cell not yet recorded in
    ``out_dir/results.json``; ``meshes`` {name: (world size, a function
    that makes the mesh over the fake world)}.  Returns the results
    dict."""
    out_dir.mkdir(parents=True, exist_ok=True)
    res_path = out_dir / "results.json"
    results = load_results(res_path)
    for mesh_name, (world, make_mesh) in meshes.items():
        todo = []
        for arch in archs:
            for shape in shapes:
                key = f"{arch}|{shape.name}|{mesh_name}"
                if n_microbatches > 1:
                    key += f"|mb{n_microbatches}"
                if perf:
                    key += f"|{perf}"
                if key in results and not force \
                        and results[key]["status"] in ("ok", "skip"):
                    print(f"[cached] {key}: {results[key]['status']}")
                    continue
                todo.append((key, arch, shape))
        if not todo:
            continue
        with fake_world(world):
            mesh = make_mesh()
            for key, arch, shape in todo:
                print(f"[run] {key} ...", flush=True)
                rec = run_cell(arch, shape, mesh, mesh_name, out_dir,
                               n_microbatches=n_microbatches, perf=perf,
                               smoke=smoke)
                results[key] = rec
                res_path.write_text(json.dumps(results, indent=1))
                status = rec["status"]
                extra = (f" trace={rec.get('lower_s')}s"
                         if status == "ok" else
                         f" {rec.get('reason') or rec.get('error')}")
                print(f"[done] {key}: {status}{extra}", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--perf", default="",
                    help="PerfFlags list, e.g. attn_remat_chunk,"
                         "bf16_tp_collectives,windowed_attention,"
                         "ssm_impl=chunked")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = SHAPES if args.shape == "all" else [
        s for s in SHAPES if s.name == args.shape]
    names = {"single": ["pod16x16"], "multi": ["pod2x16x16"],
             "both": ["pod16x16", "pod2x16x16"]}[args.mesh]
    results = sweep(archs, shapes, {n: MESHES[n] for n in names},
                    Path(args.out), force=args.force,
                    n_microbatches=args.microbatches, perf=args.perf)

    ok = sum(1 for r in results.values() if r["status"] == "ok")
    skip = sum(1 for r in results.values() if r["status"] == "skip")
    err = sum(1 for r in results.values() if r["status"] == "error")
    print(f"\nTOTAL ok={ok} skip={skip} error={err}")
    return 0 if err == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
