#!/usr/bin/env python3
"""A/B timings of the port's conv kernels on one card: this checkout
against another.

    python3 tools/conv_ab.py --other DIR [--depthwise]

``chip_smoke.py``'s conv shapes (full-width ResNet50, MobileNetV2 and
RepVGG-A0 at 224 px, microbatch 2) through both implicit-GEMM conv
kernels, or with ``--depthwise`` its ten MobileNetV2 depthwise shapes
through ``conv_depthwise``; its inputs and its timer (median of
CUDA-event timings of CUDA-graph replays of the wrapper's call, every
launch the wrapper makes included).  DIR is a checkout of another commit (for
example the parent, unpacked with ``git archive`` into a gitignored
directory); each side is timed in its own process, in turns: other,
this, this, other.  Prints the per-shape medians of both and their
ratio.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# one timing pass of a checkout's conv wrappers, run in a child process
CHILD = r"""
import json, sys, torch
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
from repro_torch.kernels import _cuda, conv_depthwise, conv_implicit, conv_sparse
_cuda.build_all([conv_implicit.KERNEL, conv_sparse.KERNEL,
                 conv_depthwise.KERNEL])
dev, gen = torch.device("cuda"), torch.Generator().manual_seed(0)
out = {}
for spec in json.loads(sys.argv[2]):
    if len(spec) == 3:                      # a depthwise (C, hw, stride)
        C, hw, stride = spec
        x = torch.randint(-127, 128, (2, hw, hw, C), generator=gen,
                          dtype=torch.int8).to(dev)
        w = torch.randint(-63, 64, (9, C), generator=gen,
                          dtype=torch.int8).to(dev)
        eff = (1e-3 * torch.rand((2, C), generator=gen)).to(dev)
        bias = (0.1 * torch.randn((C,), generator=gen)).to(dev)
        out[f"{C}@{hw}/s{stride}"] = [cs.median_ms(
            lambda: conv_depthwise.conv2d_dw(x, w, eff, bias, None, k=3,
                                             stride=stride, relu=True))]
        continue
    c = cs.conv_case(tuple(spec), dev, gen)
    kw = dict(k=c["k"], stride=c["stride"], relu=c["relu"])
    sc = c["shortcut"]
    dense = (c["x"], c["w_sp"], c["eff"], c["bias"], sc)
    packed = (c["x"], c["bitmap"], c["values"], c["eff"], c["bias"], sc)
    out[spec[0]] = [
        cs.median_ms(lambda: conv_implicit.conv2d_implicit(*dense, **kw)),
        cs.median_ms(lambda: conv_sparse.conv2d_sparse(*packed, **kw))]
print("RESULT " + json.dumps(out), flush=True)
"""


def shapes(depthwise: bool):
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    return chip_smoke.DW_SHAPES if depthwise else chip_smoke.CONV_SHAPES


def run_child(root: Path, specs) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(root),
                           json.dumps(specs)], capture_output=True,
                          text=True, check=True)
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def compare(other: Path, depthwise: bool):
    specs = [list(s) for s in shapes(depthwise)]
    kinds = ("conv_depthwise",) if depthwise else ("conv_implicit",
                                                   "conv_sparse")
    names = [f"{s[0]}@{s[1]}/s{s[2]}" if depthwise else s[0] for s in specs]
    runs = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        runs[who].append(run_child(other if who == "other" else ROOT, specs))
    print(f"{'shape':18s} {'kernel':14s} {'other ms':>9s} {'this ms':>9s} "
          f"{'this/other':>10s}")
    result = []
    for name in names:
        for i, kind in enumerate(kinds):
            o = min(r[name][i] for r in runs["other"] if name in r) \
                if all(name in r for r in runs["other"]) else None
            t = min(r[name][i] for r in runs["this"])
            ratio = None if o is None else t / o
            result.append(dict(shape=name, kernel=kind, other_ms=o,
                               this_ms=t, ratio=ratio))
            print(f"{name:18s} {kind:14s} "
                  f"{'n/a' if o is None else f'{o:.4f}':>9s} {t:9.4f} "
                  f"{'n/a' if ratio is None else f'{ratio:.3f}':>10s}",
                  flush=True)
    for kind in kinds:
        sel = [r for r in result if r["kernel"] == kind]
        if all(r["other_ms"] is not None for r in sel):
            o = sum(r["other_ms"] for r in sel)
            t = sum(r["this_ms"] for r in sel)
            print(f"{'sum':18s} {kind:14s} {o:9.4f} {t:9.4f} {t / o:10.3f}",
                  flush=True)
    print("AB " + json.dumps({"runs": runs, "rows": result}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", type=Path, required=True,
                    help="checkout of another commit to time in turns")
    ap.add_argument("--depthwise", action="store_true",
                    help="time conv_depthwise at chip_smoke.DW_SHAPES")
    args = ap.parse_args()
    compare(args.other.resolve(), args.depthwise)


if __name__ == "__main__":
    main()
