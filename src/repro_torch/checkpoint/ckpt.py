"""Leaf-per-file checkpoints in the reference's on-disk format (the port's
copy of the reference's ``checkpoint/ckpt.py``), so a checkpoint written by
either package restores in the other.

Each leaf is one ``.npy`` keyed by its tree path (dict keys sorted; the
AdamW state, a named tuple, by index: ``opt/0`` the step, ``opt/1/…`` the
first moments, ``opt/2/…`` the second); ``manifest.json`` records the
shapes, dtypes and the step.  A bfloat16 leaf is stored as its raw 16-bit
pattern (``uint16``) with ``"bits": true`` and its dtype name, as the
reference stores its ml_dtypes leaves.

Writes are atomic at directory granularity: leaves and the ``extra.json``
sidecar (host state such as the data cursor) land in a hidden sibling temp
dir, ``manifest.json`` is written last as the completeness sentinel, and
one ``os.replace`` publishes the directory.  ``latest_step`` only picks
directories that have the sentinel.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

_BITS = {"bfloat16": torch.bfloat16}   # dtypes stored as raw 16-bit patterns


def _flatten(tree: Any, path=()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten(v, path + (str(i),))
    else:
        yield path, tree


def _unflatten_into(skeleton: Any, values: Dict[str, Any], path=()) -> Any:
    if isinstance(skeleton, dict):
        return {k: _unflatten_into(v, values, path + (str(k),)) for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        t = [_unflatten_into(v, values, path + (str(i),)) for i, v in enumerate(skeleton)]
        return type(skeleton)(*t) if hasattr(skeleton, "_fields") else type(skeleton)(t)
    return values["/".join(path)]


def _to_numpy(leaf: Union[torch.Tensor, np.ndarray]) -> Tuple[np.ndarray, Dict[str, Any]]:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            return bits, {"shape": list(t.shape), "dtype": "bfloat16", "bits": True}
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, {"shape": list(arr.shape), "dtype": str(arr.dtype)}


def save(ckpt_dir: str, tree: Any, step: int = 0, *,
         extra_files: Optional[Dict[str, Any]] = None) -> None:
    """Atomically write ``tree`` as a leaf-per-file checkpoint directory;
    ``extra_files`` maps sidecar names to JSON payloads written inside the
    same atomic unit."""
    parent = os.path.dirname(os.path.abspath(ckpt_dir))
    os.makedirs(parent, exist_ok=True)
    tmp = os.path.join(parent, f".{os.path.basename(ckpt_dir)}.tmp.{os.getpid()}")
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}}
    for path, leaf in _flatten(tree):
        key = "/".join(path)
        arr, meta = _to_numpy(leaf)
        meta["file"] = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, meta["file"]), arr)
        manifest["leaves"][key] = meta
    for name, payload in (extra_files or {}).items():
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(payload, f)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    # os.replace only overwrites an empty dir: drop a stale checkpoint of
    # the same name first
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    os.replace(tmp, ckpt_dir)


def restore(ckpt_dir: str, skeleton: Any, device: Union[str, torch.device] = "cpu") -> Any:
    """The checkpoint as ``skeleton``'s tree of tensors on ``device``."""
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        manifest = json.load(f)
    values: Dict[str, torch.Tensor] = {}
    for key, meta in manifest["leaves"].items():
        arr = np.load(os.path.join(ckpt_dir, meta["file"]))
        if meta.get("bits"):
            t = torch.from_numpy(arr.view(np.int16).copy()).view(_BITS[meta["dtype"]])
        else:
            t = torch.from_numpy(arr.copy())
        values[key] = t.to(device)
    return _unflatten_into(skeleton, values)


def save_train_state(ckpt_dir: str, state: Any, step: int, *,
                     extra: Optional[Dict] = None) -> None:
    """Full-state checkpoint: params + AdamW moments + optimizer step, with
    ``extra`` (JSON host state, e.g. the data cursor) in ``extra.json``
    inside the same atomic rename."""
    save(ckpt_dir, {"params": state.params, "opt": state.opt}, step,
         extra_files=({"extra.json": extra} if extra is not None else None))


def restore_train_state(ckpt_dir: str, params_skeleton: Any,
                        device: Union[str, torch.device] = "cpu") -> Tuple[Any, int, Dict]:
    """A full TrainState from ``ckpt_dir``; returns ``(state, step, extra)``.
    ``params_skeleton`` is any tree with the params' paths (the model's
    ``params.tree()``); the restored params require grad."""
    from repro_torch.optim.adamw import AdamWState
    from repro_torch.training.train_step import TrainState

    skel = {"params": params_skeleton,
            "opt": AdamWState(step=None, mu=params_skeleton, nu=params_skeleton)}
    tree = restore(ckpt_dir, skel, device)
    for _, p in _flatten(tree["params"]):
        p.requires_grad_(p.is_floating_point())
    with open(os.path.join(ckpt_dir, "manifest.json")) as f:
        step = int(json.load(f)["step"])
    extra: Dict = {}
    ep = os.path.join(ckpt_dir, "extra.json")
    if os.path.exists(ep):
        with open(ep) as f:
            extra = json.load(f)
    return TrainState(tree["params"], tree["opt"]), step, extra


def latest_step(ckpt_root: str) -> Optional[str]:
    """Newest complete checkpoint dir (``step_N`` with its manifest) under
    ``ckpt_root``, or None."""
    if not os.path.isdir(ckpt_root):
        return None
    steps = [d for d in os.listdir(ckpt_root)
             if d.startswith("step_") and os.path.exists(os.path.join(ckpt_root, d, "manifest.json"))]
    if not steps:
        return None
    return os.path.join(ckpt_root, max(steps, key=lambda s: int(s.split("_")[1])))
