"""Atomic, resumable checkpoints of nested dicts of tensors and arrays.

  * atomicity — a checkpoint is written to `step_K.tmp/`, its manifest is
    fsync'd, and the directory is renamed to `step_K/`; a crashed writer
    never corrupts the latest complete checkpoint.
  * retention — `keep_last` prunes older checkpoints.
  * format — one `arrays.npz` of the flattened tree (keys joined by "/")
    and a `manifest.json` naming its keys, the format of
    `repro.checkpoint.Checkpointer`: a checkpoint written by either
    package loads in the other. numpy has no bfloat16, so a bf16 leaf is
    stored as the reference stores one, its raw 2-byte words as `|V2`;
    `restore` views those bits as bf16 again.

Segment-brick checkpoints (`save_segment_bricks` / `load_segment_bricks`)
persist a serving engine's cached Block-ELL bricks for a warm start.
"""
from __future__ import annotations

import base64
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:      # numpy has no bfloat16
            return leaf.view(torch.int16).numpy().view("V2")
        return leaf.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """`arr` as a tensor of `like`'s dtype on `like`'s device: 2-byte void
    words (a bf16 leaf as either package writes it) by their bits, never
    by their value."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=like.device, dtype=like.dtype)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = _to_numpy(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray], skeleton):
    """Rebuild `skeleton`'s structure from `flat`; a leaf that is a tensor
    in the skeleton comes back as a tensor of that leaf's dtype on its
    device, any other leaf as a numpy array."""
    if isinstance(skeleton, dict):
        return {k: _unflatten(
            {kk[len(k) + 1:]: vv for kk, vv in flat.items()
             if kk.split("/")[0] == k}, v)
            for k, v in skeleton.items()}
    if isinstance(skeleton, (list, tuple)):
        typ = type(skeleton)
        return typ(_unflatten(
            {kk[len(str(i)) + 1:]: vv for kk, vv in flat.items()
             if kk.split("/")[0] == str(i)}, v)
            for i, v in enumerate(skeleton))
    arr = flat[""] if "" in flat else flat[next(iter(flat))]
    if isinstance(skeleton, torch.Tensor):
        return _to_tensor(arr, skeleton)
    return arr


def latest_step(directory: str) -> Optional[int]:
    """The newest step in `directory` with a complete manifest, or None."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            manifest = os.path.join(directory, name, "manifest.json")
            if os.path.exists(manifest):
                steps.append(int(name.split("_")[1]))
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int, tmp: bool = False) -> str:
        return os.path.join(self.directory,
                            f"step_{step}" + (".tmp" if tmp else ""))

    def save(self, step: int, params, opt_state, **extra) -> str:
        """Write `{"params", "opt_state", **extra}` (None extras dropped)
        as step `step`; returns the checkpoint's directory."""
        tree = {"params": params, "opt_state": opt_state}
        tree.update({k: v for k, v in extra.items() if v is not None})
        flat = _flatten(tree)
        tmp = self._path(step, tmp=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {
            "step": step,
            "keys": sorted(flat.keys()),
            "nbytes": int(sum(a.nbytes for a in flat.values())),
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        final = self._path(step)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._prune()
        return final

    def restore(self, skeleton, step: Optional[int] = None) -> Tuple[Any, int]:
        """`skeleton`: a tree with the target structure (values give only
        the leaf kind and, for tensors, the dtype and device). Returns
        (tree, step) from the newest complete checkpoint, or from `step`."""
        if step is None:
            step = latest_step(self.directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._path(step)
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: data[k] for k in manifest["keys"]}
        return _unflatten(flat, skeleton), step

    def _prune(self) -> None:
        steps = sorted(
            int(n.split("_")[1]) for n in os.listdir(self.directory)
            if n.startswith("step_") and not n.endswith(".tmp"))
        for s in steps[: -self.keep_last]:
            shutil.rmtree(self._path(s), ignore_errors=True)


# ---- segment-brick checkpoints (serving warm start) -------------------------
#
# Cache keys are content-addressed (`graph_cache_prefix` namespaces), so the
# bricks one serving process checkpoints are the bricks a later process's
# streams look up. Each brick is (metadata, arrays): the metadata (the
# SegmentKey fields and the BlockELL geometry) rides in the array names as
# urlsafe-base64 JSON, which never contains the "/" of the flattened-tree
# format, so the manifest stays the single source of truth and the publish
# stays atomic. Bricks live in their own subdirectory: the brick
# Checkpointer keeps only the last step, and must never prune a training
# checkpoint kept in the same directory.

BRICKS_SUBDIR = "segment_bricks"


def _encode_brick_meta(meta: Dict[str, Any]) -> str:
    blob = json.dumps(meta, sort_keys=True).encode()
    return base64.urlsafe_b64encode(blob).decode().rstrip("=")


def _decode_brick_meta(token: str) -> Dict[str, Any]:
    pad = "=" * (-len(token) % 4)
    return json.loads(base64.urlsafe_b64decode(token + pad))


def save_segment_bricks(
    directory: str,
    bricks: List[Tuple[Dict[str, Any], Dict[str, np.ndarray]]],
    step: int = 0,
) -> str:
    """Atomically persist cache bricks as (json-able meta, named arrays)."""
    params = {
        _encode_brick_meta(meta): {k: _to_numpy(v) for k, v in arrays.items()}
        for meta, arrays in bricks
    }
    target = os.path.join(directory, BRICKS_SUBDIR)
    return Checkpointer(target, keep_last=1).save(step, params, opt_state={})


def load_segment_bricks(
    directory: str,
    step: Optional[int] = None,
) -> List[Tuple[Dict[str, Any], Dict[str, np.ndarray]]]:
    """Read back the newest (or given) brick checkpoint; [] if none.

    Keys that do not parse as brick entries (wrong arity, undecodable
    metadata) are skipped: `directory` may predate, or never have been, a
    brick checkpoint.
    """
    target = os.path.join(directory, BRICKS_SUBDIR)
    if step is None:
        step = latest_step(target)
    if step is None:
        return []
    path = os.path.join(target, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    grouped: Dict[str, Dict[str, np.ndarray]] = {}
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for key in manifest["keys"]:
            parts = key.split("/")
            if len(parts) != 3 or parts[0] != "params":
                continue
            grouped.setdefault(parts[1], {})[parts[2]] = data[key]
    out = []
    for token, arrays in grouped.items():
        try:
            meta = _decode_brick_meta(token)
        except (ValueError, json.JSONDecodeError):
            continue
        out.append((meta, arrays))
    return out
