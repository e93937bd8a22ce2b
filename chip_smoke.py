#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA host

1. prints the card (``nvidia-smi`` name and power limit) and builds the
   three CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
   source, all started together);
2. holds each kernel against its plain PyTorch version on the card at the
   main path's shapes (N = 2 images, per-row scales): int32 accumulators
   equal, ``y`` within 1 ulp, requantized int8 codes off by at most 1 on
   at most 1e-5 of them; times each (median of CUDA-event timings) beside
   its bound and, where one PyTorch call computes the same function, that
   call;
3. serves full-width ResNet50 (configs/resnet50_compiled.py, seeded
   random weights) through ``PipelineEngine`` in ``int8`` and
   ``sparse_cfmm`` at 1 and 2 stages on the one card: three requests of
   1, 2 and 3 images at microbatch 2.  Checks finite logits, and top-1
   and max |dlogit| (tolerance 0) of the first request against the same
   forward on the CPU's plain versions, and that the launch counters
   show 53 conv launches per microbatch (+1 ``sparse_matvec`` in
   ``sparse_cfmm``);
4. prints the ``kernels`` JSON line, then ``{"ok": true, ...}`` last.

Any failed check raises: the script exits non-zero and prints no ``ok``
line.  It also fails without CUDA, and outside a checkout of the repo.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PEAK_INT8_OPS = 1979e12      # H100 SXM dense int8 tensor-core rate, op/s
PEAK_BYTES = 3.35e12         # H100 SXM HBM3, bytes/s
CONVS_PER_FORWARD = 53       # ResNet50: stem + 16 blocks x 3 + 4 projections
TIMING_REPS = 25
SERVE_REPS = 5


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps=TIMING_REPS, per_graph=10) -> float:
    """Device time of one ``fn()`` call: ``per_graph`` calls captured in a
    CUDA graph, the graph replayed ``reps`` times between CUDA events,
    median over the replays divided by ``per_graph``.  The graph keeps
    the host's per-call Python and launch overhead out of the number."""
    for _ in range(3):                       # warm up: builds, allocator
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_graph)
    del graph
    return float(np.median(times))


def ulp_distance(a: torch.Tensor, b: torch.Tensor) -> int:
    """Max distance in representable f32 steps between a and b."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(a) - ordered(b)).abs().max().item())


def popcount(bitmap: torch.Tensor) -> int:
    return sum(int(((bitmap >> j) & 1).sum()) for j in range(8))


def bound_ms(ops: float, nbytes: float) -> tuple:
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

# (name, k, stride, c_in, c_out, input hw, relu, shortcut kind)
CONV_SHAPES = [
    ("stem", 7, 2, 3, 64, 224, True, None),
    ("conv2_x_2/b", 3, 1, 64, 64, 56, True, None),
    ("conv3_x_1/a", 1, 2, 256, 128, 56, True, None),
    ("conv4_x_2/b", 3, 1, 256, 256, 14, True, None),
    ("conv5_x_1/c", 1, 1, 512, 2048, 7, True, "f32"),
    ("conv5_x_2/c", 1, 1, 512, 2048, 7, True, "int8"),
]


def conv_case(spec, dev, gen):
    """Inputs of one main-path conv: int8 activations, dense and
    bitmap-packed weights compiled as the model compiles them, per-row
    dequant rows, bias and the shortcut."""
    from repro_torch.core.compiled_linear import _compile_leaf_2d
    name, k, stride, c_in, c_out, hw, relu, sc_kind = spec
    N = 2
    x = torch.randint(-127, 128, (N, hw, hw, c_in), generator=gen,
                      dtype=torch.int8)
    w = torch.randn((c_in * k * k, c_out), generator=gen) / (c_in * k * k) ** .5
    dense = _compile_leaf_2d(w, "int8", 0.8, conv_k=k)
    packed = _compile_leaf_2d(w, "sparse_cfmm", 0.8, conv_k=k)
    x_scale = 0.02 + 0.01 * torch.rand((N,), generator=gen)
    eff = (x_scale.reshape(-1, 1) * dense["scale"].reshape(1, -1)).float()
    bias = 0.1 * torch.randn((c_out,), generator=gen)
    h_out = -(-hw // stride)
    shortcut = None
    if sc_kind == "f32":
        shortcut = torch.randn((N, h_out, h_out, c_out), generator=gen)
    elif sc_kind == "int8":
        shortcut = (torch.randint(-127, 128, (N, h_out, h_out, c_out),
                                  generator=gen, dtype=torch.int8),
                    0.02 + 0.01 * torch.rand((N,), generator=gen))
    to = lambda t: t.to(dev).contiguous()
    sc = (None if shortcut is None else
          (tuple(map(to, shortcut)) if isinstance(shortcut, tuple)
           else to(shortcut)))
    return dict(name=name, k=k, stride=stride, relu=relu, x=to(x),
                w_sp=to(dense["values"]), bitmap=to(packed["bitmap"]),
                values=to(packed["values"]), eff=to(eff), bias=to(bias),
                shortcut=sc, sc_kind=sc_kind, N=N, h_out=h_out,
                c_in=c_in, c_out=c_out, hw=hw)


def conv_bytes(c, weight_bytes):
    N, m, n_out = c["N"], c["h_out"] ** 2, c["c_out"]
    b = (c["x"].numel() + weight_bytes + c["eff"].numel() * 4
         + n_out * 4 + N * m * n_out * 4 + N * 4)
    if c["sc_kind"] == "f32":
        b += N * m * n_out * 4
    elif c["sc_kind"] == "int8":
        b += N * m * n_out + N * 4
    return b


def check_conv_kernel(kind, c):
    """One conv kernel at one shape against its plain version, on the
    card.  Returns the shape's row for the kernels line."""
    from repro_torch.kernels import conv_implicit, conv_sparse, ops
    kw = dict(k=c["k"], stride=c["stride"], relu=c["relu"])
    if kind == "conv_implicit":
        args = (c["x"], c["w_sp"], c["eff"], c["bias"], c["shortcut"])
        kern, plain = conv_implicit.conv2d_implicit, \
            conv_implicit.conv2d_implicit_plain
        nnz = c["w_sp"].numel()        # a dense product does every MAC
        wbytes = c["w_sp"].numel()
    else:
        args = (c["x"], c["bitmap"], c["values"], c["eff"], c["bias"],
                c["shortcut"])
        kern, plain = conv_sparse.conv2d_sparse, \
            conv_sparse.conv2d_sparse_plain
        nnz = popcount(c["bitmap"])   # only nonzero weights need a MAC
        wbytes = c["bitmap"].numel() + c["values"].numel()
    y, amax, acc = kern(*args, return_acc=True, **kw)
    y_p, amax_p, acc_p = plain(*args, return_acc=True, **kw)
    torch.cuda.synchronize()
    acc_equal = bool(torch.equal(acc, acc_p))
    ulps = ulp_distance(y, y_p)
    dy = float((y - y_p).abs().max())
    s, s_p = ops.requant_scale(amax), ops.requant_scale(amax_p)
    q = torch.clamp(torch.round(y / s.reshape(-1, 1, 1, 1)), -127, 127)
    q_p = torch.clamp(torch.round(y_p / s_p.reshape(-1, 1, 1, 1)), -127, 127)
    dq = (q - q_p).abs()
    mism = int((dq > 0).sum())
    frac = mism / q.numel()
    check(acc_equal, f"{kind} {c['name']}: int32 accumulators differ")
    check(ulps <= 1, f"{kind} {c['name']}: y off by {ulps} ulp")
    check(int(dq.max()) <= 1 and frac <= 1e-5,
          f"{kind} {c['name']}: {mism} y_q codes differ (max "
          f"{int(dq.max())})")
    ms = median_ms(lambda: kern(*args, **kw))
    plain_ms = median_ms(lambda: plain(*args, **kw), per_graph=2)
    m_total = c["N"] * c["h_out"] ** 2
    ops_needed = 2.0 * m_total * nnz          # nonzero weights only
    b_ms, b_by = bound_ms(ops_needed, conv_bytes(c, wbytes))
    library_ms = None
    if (kind == "conv_implicit" and c["k"] == 1 and c["stride"] == 1
            and m_total > 16):
        # a 1x1 stride-1 conv's int32 product is one torch._int_mm of the
        # flattened input (yardstick only; the port never calls it)
        a = c["x"].reshape(m_total, c["c_in"])
        b = c["w_sp"].t().contiguous().t()
        check(torch.equal(torch._int_mm(a, b).reshape(acc.shape), acc),
              f"{c['name']}: torch._int_mm disagrees with the kernel")
        library_ms = median_ms(lambda: torch._int_mm(a, b))
    print(f"[kernel] {kind:13s} {c['name']:12s} acc_equal={acc_equal} "
          f"max|dy|={dy:.3g} ({ulps} ulp) y_q_mismatch={mism} "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} "
          f"bound_ms={b_ms:.4f} ({b_by}) library_ms="
          f"{'null' if library_ms is None else f'{library_ms:.4f}'}",
          flush=True)
    return dict(shape=c["name"], ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms, max_abs_err=dy,
                ulps=ulps, y_q_mismatch=mism)


def check_sparse_matvec(dev, gen):
    from repro_torch.core.compiled_linear import _compile_leaf_2d, act_quant
    from repro_torch.kernels import ref, sparse_matvec
    M, K, N = 2, 2048, 1000
    w = torch.randn((K, N), generator=gen) / K ** .5
    packed = _compile_leaf_2d(w, "sparse_cfmm", 0.8)
    x_q, _ = act_quant(torch.randn((M, K), generator=gen).clamp_min(0),
                       per_row=True)
    x_q, bm, vals = (t.to(dev).contiguous() for t in
                     (x_q, packed["bitmap"], packed["values"]))
    out = sparse_matvec.sparse_matvec(x_q, bm, vals)
    out_p = ref.sparse_matvec_ref(x_q, bm, vals)
    torch.cuda.synchronize()
    check(torch.equal(out, out_p), "sparse_matvec: int32 products differ")
    err = float((out - out_p).abs().max())
    ms = median_ms(lambda: sparse_matvec.sparse_matvec(x_q, bm, vals))
    plain_ms = median_ms(lambda: ref.sparse_matvec_ref(x_q, bm, vals),
                         per_graph=2)
    nnz = popcount(bm)
    b_ms, b_by = bound_ms(2.0 * M * nnz, x_q.numel() + bm.numel()
                          + vals.numel() + M * N * 4)
    print(f"[kernel] sparse_matvec M={M} K={K} N={N} equal=True "
          f"kernel_ms={ms:.4f} plain_ms={plain_ms:.3f} bound_ms={b_ms:.5f} "
          f"({b_by}) library_ms=null", flush=True)
    return dict(shape=f"head M={M} K={K} N={N}", ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                max_abs_err=err)


# ---------------------------------------------------------------------------
# Phase 3: the main path — full-width ResNet50 served on the card
# ---------------------------------------------------------------------------

def profile_serve(eng, images, mode):
    """Where a served batch's time goes: one more run of ``eng`` under
    ``torch.profiler``; prints wall time, the card's busy time (sum of
    kernel times on the one stream) and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.pipeline import PipelineRequest
    reqs = [PipelineRequest(rid=i, images=im) for i, im in enumerate(images)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only: an aten op's own row repeats the time of
    # the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if not events:
        print(f"[profile] {mode}: wall {wall_ms:.1f} ms; device time not "
              "measured (the profiler saw no kernels)", flush=True)
        return
    ours_ms = sum(e.self_device_time_total for e in events
                  if "repro::" in e.key or "sparse_matvec_kernel" in e.key
                  ) / 1e3
    print(f"[profile] {mode} n_stages=1: wall {wall_ms:.1f} ms, device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.1f}%), idle "
          f"{100 * (1 - busy_ms / wall_ms):.1f}%; the port's kernels "
          f"{ours_ms:.2f} ms of it; device launches "
          f"{sum(e.count for e in events)}", flush=True)
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"x{e.count:5d}  {e.key[:90]}", flush=True)


def serve_resnet50(kernels, card):
    from repro_torch.configs.resnet50_compiled import CONFIG as cfg
    from repro_torch.core.compiled_linear import ensure_compiled
    from repro_torch.models import resnet
    from repro_torch.serving.pipeline import (PipelineEngine,
                                              PipelineRequest,
                                              reference_logits)
    t0 = time.perf_counter()
    params = resnet.init(torch.Generator().manual_seed(0), cfg)
    print(f"[serve] ResNet50 width {cfg.width_mult} hw {cfg.in_hw} classes "
          f"{cfg.num_classes}: init {time.perf_counter() - t0:.1f}s",
          flush=True)
    rng = np.random.RandomState(0)
    images = [rng.randn(n, cfg.in_hw, cfg.in_hw, 3).astype(np.float32)
              for n in (1, 2, 3)]
    n_img = sum(len(im) for im in images)
    results = {}
    for mode in ("int8", "sparse_cfmm"):
        t0 = time.perf_counter()
        compiled = ensure_compiled(params, mode, 0.8)
        t_compile = time.perf_counter() - t0
        t0 = time.perf_counter()
        ref_cpu = reference_logits(compiled, cfg,
                                   torch.from_numpy(images[0]), 2).numpy()
        t_ref = time.perf_counter() - t0
        print(f"[serve] {mode}: compile {t_compile:.1f}s, CPU plain "
              f"forward of request 0 {t_ref:.1f}s", flush=True)
        by_stages = {}
        for n_stages in (1, 2):
            eng = PipelineEngine(cfg, compiled, mode=mode, n_stages=n_stages,
                                 microbatch=2, device="cuda")
            eng.run([PipelineRequest(rid=i, images=im)
                     for i, im in enumerate(images)])        # warm-up
            eng.reset_counters()
            for kern in kernels.values():
                kern.launches = 0
            times = []
            for _ in range(SERVE_REPS):
                reqs = [PipelineRequest(rid=i, images=im)
                        for i, im in enumerate(images)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                eng.run(reqs)                # reads every output back
                times.append(time.perf_counter() - t0)
            counts = {name: kern.launches for name, kern in kernels.items()}
            dt = float(np.median(times))
            n_mb = eng.stats()["mb_injected"]   # over all SERVE_REPS runs
            conv_name = "conv_implicit" if mode == "int8" else "conv_sparse"
            other = "conv_sparse" if mode == "int8" else "conv_implicit"
            check(counts[conv_name] == CONVS_PER_FORWARD * n_mb,
                  f"{mode}/{n_stages}: {counts[conv_name]} {conv_name} "
                  f"launches for {n_mb} microbatches")
            check(counts[other] == 0, f"{mode}: {other} launched")
            want_mv = n_mb if mode == "sparse_cfmm" else 0
            check(counts["sparse_matvec"] == want_mv,
                  f"{mode}/{n_stages}: {counts['sparse_matvec']} "
                  f"sparse_matvec launches, want {want_mv}")
            for r in reqs:
                check(r.done and r.logits.shape == (len(r.images),
                                                    cfg.num_classes),
                      f"{mode}: request {r.rid} incomplete")
                check(np.isfinite(r.logits).all(),
                      f"{mode}: non-finite logits")
            d_logit = float(np.abs(reqs[0].logits - ref_cpu).max())
            top1 = bool((reqs[0].logits.argmax(-1)
                         == ref_cpu.argmax(-1)).all())
            check(top1, f"{mode}/{n_stages}: top-1 differs from the CPU "
                  "plain forward")
            # every op on the path is exact or IEEE-rounded the same way on
            # both devices, so the tolerance is zero
            check(d_logit == 0.0, f"{mode}/{n_stages}: logits differ from "
                  f"the CPU plain forward by up to {d_logit:.3g}")
            by_stages[n_stages] = np.concatenate([r.logits for r in reqs])
            st = eng.stats()
            print(f"[serve] {mode} n_stages={n_stages} microbatch=2: "
                  f"{n_img} images in {dt * 1e3:.1f} ms (median of "
                  f"{SERVE_REPS}; min {min(times) * 1e3:.1f}, max "
                  f"{max(times) * 1e3:.1f}) = {n_img / dt:.1f} im/s on "
                  f"{card}; launches {counts}; vs CPU plain: "
                  f"top1_equal={top1} max|dlogit|={d_logit:.3g}; bubble "
                  f"{st['bubble_fraction']:.2f}", flush=True)
            results[(mode, n_stages)] = dict(counts=counts, im_s=n_img / dt,
                                             d_logit=d_logit)
            if n_stages == 1:
                profile_serve(eng, images, mode)
        check(np.array_equal(by_stages[1], by_stages[2]),
              f"{mode}: 1-stage and 2-stage logits differ")
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.kernels import (_cuda, conv_implicit, conv_sparse,
                                     sparse_matvec)
    card = gpu_identity()
    print(f"[card] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)
    kernels = {"conv_implicit": conv_implicit.KERNEL,
               "conv_sparse": conv_sparse.KERNEL,
               "sparse_matvec": sparse_matvec.KERNEL}
    t0 = time.perf_counter()
    logs = _cuda.build_all(kernels.values())
    print(f"[build] {len(kernels)} kernels in {time.perf_counter() - t0:.1f}s",
          flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[ptxas] {src}: {line.strip()}", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rows = {"conv_implicit": [], "conv_sparse": []}
    for spec in CONV_SHAPES:
        c = conv_case(spec, dev, gen)
        for kind in rows:
            rows[kind].append(check_conv_kernel(kind, c))
    rows["sparse_matvec"] = [check_sparse_matvec(dev, gen)]

    served = serve_resnet50(kernels, card)

    meta = {
        "conv_implicit": ("src/repro_torch/csrc/conv_implicit.cu",
                          "src/repro/kernels/conv_implicit.py:144"),
        "conv_sparse": ("src/repro_torch/csrc/conv_sparse.cu",
                        "src/repro/kernels/conv_sparse.py:90"),
        "sparse_matvec": ("src/repro_torch/csrc/sparse_matvec.cu",
                          "src/repro/kernels/sparse_matvec.py:55"),
    }
    entries = []
    for name, shape_rows in rows.items():
        ops_ms = sum(r["bound_ms"] for r in shape_rows
                     if r["bound_by"] == "operations")
        bytes_ms = sum(r["bound_ms"] for r in shape_rows
                       if r["bound_by"] == "bytes")
        entries.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": sum(v["counts"][name] for v in served.values()),
            "max_abs_err": max(r["max_abs_err"] for r in shape_rows),
            "ms": sum(r["ms"] for r in shape_rows),
            "plain_ms": sum(r["plain_ms"] for r in shape_rows),
            "bound_ms": sum(r["bound_ms"] for r in shape_rows),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "status": (f"built, launched on the main path, equal to its "
                       f"plain version at {len(shape_rows)} shape(s)"),
            "shapes": shape_rows,
        })
    print(f"[card] {card}", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
