"""Fault-tolerant checkpointing (ports ``repro/checkpoint/checkpoint.py``,
on the same on-disk layout, so a checkpoint one package writes restores
in the other).

Layout:  <dir>/step_<N>/
            manifest.json   — leaf names, shapes, dtypes, sha256 of each
                              blob, writer process count
            arrays_<proc>.npz
         <dir>/LATEST       — atomically updated pointer

Leaves are named as the JAX package names them: the path of dict keys,
list indices and ``.field`` for a NamedTuple field, joined by ``/``
(``0/embed/table``, ``1/.step``, ``1/.m/...`` for a ``(params,
opt_state)`` tuple).  Blobs and manifest are written to ``step_N.tmp``
and renamed; ``LATEST`` is updated last, so a crash mid-save never
corrupts the restore point; every blob is hashed and checked on restore;
the ``keep_last`` newest checkpoints are kept.  npz has no bfloat16:
such a leaf is stored as its uint16 bits and read back through an int16
view of the same bits (no ``ml_dtypes``).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch import nn

_DTYPES = {"float32": torch.float32, "float64": torch.float64,
           "bfloat16": torch.bfloat16, "float16": torch.float16,
           "int32": torch.int32, "int64": torch.int64, "int8": torch.int8,
           "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def _flatten(tree):
    flat = nn.tree_flatten_with_path(tree)
    names = ["/".join(str(k) for k in path) for path, _ in flat]
    return names, [v for _, v in flat]


def _to_numpy(v) -> tuple:
    """-> (stored array, dtype name) of one leaf."""
    t = torch.as_tensor(v).detach().cpu()
    if t.dtype == torch.bfloat16:      # npz has no bf16: its u16 bits
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    return t.numpy(), _NAMES[t.dtype]


def _process_count() -> int:
    dist = torch.distributed
    return (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else 1)


def save(ckpt_dir, step: int, tree, keep_last: int = 3,
         process_index: int = 0, blocking: bool = True):
    """Save a tensor tree.  Returns the checkpoint path (and the writer
    thread when ``blocking`` is False)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    names, vals = _flatten(tree)
    stored = [_to_numpy(v) for v in vals]     # off the device before a thread

    def _write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays, meta = {}, {}
        for name, (arr, dtype) in zip(names, stored):
            meta[name] = dict(shape=list(arr.shape), dtype=dtype)
            arrays[name] = arr
        blob = tmp / f"arrays_{process_index}.npz"
        np.savez(blob, **arrays)
        with open(blob, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()
        manifest = dict(step=step, names=names, meta=meta,
                        blobs={f"arrays_{process_index}.npz": digest},
                        n_processes=_process_count(), time=time.time())
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        os.replace(tmp, final)
        latest = ckpt_dir / "LATEST"
        latest_tmp = ckpt_dir / "LATEST.tmp"
        latest_tmp.write_text(final.name)
        os.replace(latest_tmp, latest)
        _retain(ckpt_dir, keep_last)

    if blocking:
        _write()
    else:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        return final, t
    return final


def _retain(ckpt_dir: pathlib.Path, keep_last: int):
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for p in steps[:-keep_last]:
        shutil.rmtree(p, ignore_errors=True)


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = pathlib.Path(ckpt_dir)
    latest = ckpt_dir / "LATEST"
    if not latest.exists():
        return None
    name = latest.read_text().strip()
    if not (ckpt_dir / name / "manifest.json").exists():
        # LATEST points at a corrupt/missing save: fall back to newest valid
        cands = sorted(p.name for p in ckpt_dir.glob("step_*") if
                       (p / "manifest.json").exists())
        if not cands:
            return None
        name = cands[-1]
    return int(name.split("_")[1])


def restore(ckpt_dir, tree_like, step: int | None = None):
    """Restore into the structure of ``tree_like`` (each leaf's values
    replaced, in its dtype and on its device).  Returns (tree, step)."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    path = ckpt_dir / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    arrays = {}
    for blob, digest in manifest["blobs"].items():
        data = (path / blob).read_bytes()
        actual = hashlib.sha256(data).hexdigest()
        if actual != digest:
            raise IOError(f"checkpoint blob {blob} corrupt "
                          f"(sha256 {actual} != {digest})")
        with np.load(path / blob) as z:
            arrays.update({k: z[k] for k in z.files})
    names, vals = _flatten(tree_like)
    missing = [n for n in names if n not in arrays]
    if missing:
        raise KeyError(f"checkpoint missing {len(missing)} leaves, "
                       f"e.g. {missing[:3]}")
    meta = manifest["meta"]
    new_vals = []
    for n, v in zip(names, vals):
        arr = arrays[n]
        if meta[n]["dtype"] == "bfloat16":    # stored as its u16 bits
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        like = torch.as_tensor(v)
        new_vals.append(t.to(like.dtype).reshape(like.shape).to(
            like.device))
    it = iter(new_vals)
    return _rebuild(tree_like, it), step


def _rebuild(tree, it):
    """``tree``'s structure with its leaves taken from ``it`` in
    ``tree_flatten_with_path`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        new = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)
