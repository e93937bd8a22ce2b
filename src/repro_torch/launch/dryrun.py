"""Production-mesh dry run: every (arch x shape x mesh) cell on the meta
device (ports ``repro/launch/dryrun.py``).

For each cell this:
  1. builds the production mesh's logical shape (16 x 16 single-pod,
     2 x 16 x 16 multi-pod: 256 or 512 H100s; ``launch/mesh.py``);
  2. builds the parameter, optimizer and cache trees on the meta device
     (``nn.SHAPE_ONLY``: shapes and dtypes, nothing allocated — the
     counterpart of ``jax.eval_shape``);
  3. shards them by the logical-axis rules (``distributed/sharding.py``)
     and sums each device's bytes of parameters, optimizer state, cache
     and batch (the counterpart of XLA's argument bytes; temporaries have
     no counterpart: eager meta tensors have no buffer assignment);
  4. runs the train step (train shapes) or the prefill / decode step
     (inference shapes) on the meta device under ``FlopCounterMode``,
     every kernel wrapper taking its plain version as JAX's dry run
     lowers its jnp references;
  5. writes the record, with the analytic roofline on H100 SXM constants
     as the primary terms (``roofline/analytic.py``), to
     ``build/dryrun/<single|multi>/<arch>__<shape>.json``.

The numbers are projections from shapes and the H100's published peaks,
not measurements.

Usage:
  python -m repro_torch.launch.dryrun --arch smollm_360m --shape train_4k \
      --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both --jobs 4
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import nn
from repro_torch.configs.base import (ARCH_IDS, SHAPES, cell_applicable,
                                      get_config, input_specs)
from repro_torch.core.compiled_linear import compile_params
from repro_torch.distributed import sharding as shd
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import lm
from repro_torch.roofline import analysis, analytic
from repro_torch.training import optimizer, train_step as ts

ART_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "dryrun"


def _nbytes(t: torch.Tensor, spec: tuple, sizes: dict) -> int:
    """Bytes of ``t`` on one device under ``spec``: its bytes over the
    product of the mesh axes the spec shards it on."""
    ways = math.prod(sizes[a] for e in spec if e is not None
                     for a in (e if isinstance(e, tuple) else (e,)))
    return t.numel() * t.element_size() // ways


def device_bytes(tree, mesh, rules: dict) -> int:
    """Bytes one device holds of a Param tree sharded by ``rules``."""
    sizes = shd.mesh_shape(mesh)
    return sum(_nbytes(p.value, shd.spec_for(p.axes, tuple(p.value.shape),
                                             rules, mesh), sizes)
               for p in nn.tree_leaves(tree, is_leaf=lambda x:
                                       isinstance(x, nn.Param))
               if isinstance(p, nn.Param))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             serve_mode: str = "cfmm", variant: str = "baseline",
             extra: dict | None = None, rules_name: str | None = None,
             kv_dtype: str | None = None) -> dict:
    cfg = get_config(arch)
    if extra:
        cfg = dataclasses.replace(cfg, **extra)
    shape = SHAPES[shape_name]
    ok, why = cell_applicable(cfg, shape_name)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True,
                "reason": why}
    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    t0 = time.time()

    params = lm.init(nn.SHAPE_ONLY, cfg)
    n_params = analysis.count_params_from_shapes(params)
    n_active = analysis.active_param_count(cfg, n_params)
    batch = input_specs(cfg, shape_name)
    step = shape["step"]
    flops = FlopCounterMode(display=False)
    mem = {}

    if step == "train":
        rules = shd.RULES_BY_NAME[rules_name or "train"]
        opt = optimizer.init(nn.unbox(params))
        dp_axes = (("pod", "data", "model")
                   if rules_name == "dp_only" else ("pod", "data"))
        b_spec = shd.batch_shardings(batch, mesh, dp_axes)
        mem["params_bytes"] = device_bytes(params, mesh, rules)
        # m and v: f32 like the parameters, sharded like them; the step
        # counter (int32) replicates
        mem["opt_state_bytes"] = 2 * mem["params_bytes"] + 4
        fn = ts.make_train_step(cfg)
        with shd.use_rules(rules), shd.use_mesh(mesh), flops:
            fn(nn.unbox(params), opt, batch)
    else:
        rules = shd.RULES_BY_NAME[rules_name or "serve"]
        serve = compile_params(params, mode=serve_mode)
        S_enc = None
        if cfg.encoder_decoder:
            S_enc = 1500 if step == "decode" else shape["seq"]
        cache = lm.cache_init(cfg, shape["batch"], shape["seq"], S_enc=S_enc,
                              kv_dtype=(torch.int8 if kv_dtype == "int8"
                                        else None), device="meta")
        b_spec = shd.batch_shardings(batch, mesh)
        mem["params_bytes"] = device_bytes(serve, mesh, rules)
        mem["cache_bytes"] = device_bytes(cache, mesh, rules)
        fn = ts.make_serve_step(cfg, kind=step)
        with shd.use_rules(rules), shd.use_mesh(mesh), flops:
            fn(nn.unbox(serve), nn.unbox(cache), batch)
    mem["batch_bytes"] = sum(_nbytes(t, b_spec[k], shd.mesh_shape(mesh))
                             for k, t in batch.items())
    mem["argument_bytes"] = sum(mem.values())
    mem["temporaries"] = ("not available: eager meta tensors have no "
                          "buffer assignment")

    counted = flops.get_total_flops()
    mflops = analysis.model_flops_for(cfg, n_params, n_active, shape, step)
    roof = analytic.roofline_of(
        cfg, shape_name, shd.mesh_shape(mesh), n_params, n_active,
        serve_mode, model_flops=mflops, rules_name=rules_name)
    return {
        "arch": arch, "shape": shape_name, "step": step,
        "mesh": "2x16x16" if multi_pod else "16x16", "chips": chips,
        "variant": variant, "rules": rules_name, "kv_dtype": kv_dtype,
        "serve_mode": serve_mode if step != "train" else None,
        "n_params": n_params, "n_active_params": n_active,
        "dryrun_s": round(time.time() - t0, 2),
        "memory_per_device": mem,
        # every device's share of the counted work, split evenly: the
        # guard's replicated work shows in the analytic terms only
        "counted": {"flops_global": counted,
                    "flops_per_device": counted / chips},
        "roofline": roof.to_dict(),
        "hardware": "H100 SXM constants (roofline/analysis.py); an "
                    "analytic projection, not a measurement",
    }


def artifact_path(arch, shape_name, multi_pod, variant="baseline"):
    mesh_dir = "multi" if multi_pod else "single"
    sub = ART_DIR / mesh_dir
    sub.mkdir(parents=True, exist_ok=True)
    suffix = "" if variant == "baseline" else f"__{variant}"
    return sub / f"{arch}__{shape_name}{suffix}.json"


def _run_all(args) -> int:
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    jobs = [(arch, shape, mp) for arch in ARCH_IDS for shape in SHAPES
            for mp in meshes
            if args.force or not artifact_path(arch, shape, mp,
                                               args.variant).exists()]
    print(f"dryrun: {len(jobs)} cells", flush=True)
    extra = [f"--{k.replace('_', '-')}={v}" for k, v in
             (("serve_mode", args.serve_mode), ("variant", args.variant),
              ("rules", args.rules), ("kv_dtype", args.kv_dtype))
             if v is not None]
    procs, failed = [], []
    while jobs or procs:
        while jobs and len(procs) < args.jobs:
            arch, shape, mp = jobs.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape,
                   "--mesh", "multi" if mp else "single", *extra]
            procs.append(((arch, shape, mp), subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL)))
        for k, p in [(k, p) for k, p in procs if p.poll() is not None]:
            procs.remove((k, p))
            status = "ok" if p.returncode == 0 else \
                f"FAIL rc={p.returncode}"
            if p.returncode:
                failed.append(k)
            print(f"  {k[0]}/{k[1]}/{'multi' if k[2] else 'single'}: "
                  f"{status}", flush=True)
        time.sleep(0.2)
    return 1 if failed else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=("single", "multi", "both"),
                    default="single")
    ap.add_argument("--serve-mode", default="cfmm")
    ap.add_argument("--rules", default=None)
    ap.add_argument("--kv-dtype", default=None)
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)

    if args.all:
        return _run_all(args)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape, or --all")
    mp = args.mesh == "multi"
    try:
        rec = run_cell(args.arch, args.shape, mp, args.serve_mode,
                       args.variant, rules_name=args.rules,
                       kv_dtype=args.kv_dtype)
    except Exception:
        rec = {"arch": args.arch, "shape": args.shape,
               "mesh": "multi" if mp else "single", "variant": args.variant,
               "error": traceback.format_exc()}
    out = artifact_path(args.arch, args.shape, mp, args.variant)
    out.write_text(json.dumps(rec, indent=1, default=float))
    roof = rec.get("roofline", {})
    print(json.dumps({
        **{k: rec.get(k) for k in ("arch", "shape", "mesh", "skipped",
                                   "n_params", "n_active_params",
                                   "dryrun_s")},
        "argument_bytes_per_device":
            rec.get("memory_per_device", {}).get("argument_bytes"),
        "counted_flops_per_device": rec.get("counted", {}).get(
            "flops_per_device"),
        **{k: roof.get(k) for k in ("flops_per_device", "compute_s",
                                    "memory_s", "collective_s",
                                    "dominant")},
        "artifact": str(out)}, default=float), flush=True)
    if "error" in rec:
        print(rec["error"], file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
