"""Checkpoint / resume for the LM optimizer.

Capability parity: the reference saves/loads scene state (`.mat` files —
SURVEY.md §2.1 R8, §5); here it is deterministic resumable optimizer state
(SURVEY.md §2.2 N13): cameras, points, λ, iteration count, best cost —
enough to restart a distributed run from the last accepted state
(SURVEY.md §5 "failure detection / elastic recovery" row).

Format: one ``.npz`` of arrays (numpy only, no pickled objects) + a JSON
manifest. All arrays are materialized to host before writing; loading
returns numpy (the caller re-places onto devices/mesh).
"""

from __future__ import annotations

import json
import os

import numpy as np


def save_checkpoint(path: str, *, cameras, points, lam=None, iteration=0,
                    cost=None, extra: dict | None = None) -> None:
    """Write optimizer state. ``path`` is a directory."""
    os.makedirs(path, exist_ok=True)
    tensors = {
        "cameras": np.asarray(cameras),
        "points": np.asarray(points),
    }
    manifest = {
        "iteration": int(iteration),
        "lam": float(lam) if lam is not None else None,
        "cost": float(cost) if cost is not None else None,
        "format_version": 1,
    }
    if extra:
        for k, v in extra.items():
            if isinstance(v, np.ndarray):
                tensors[f"extra.{k}"] = v
            else:
                manifest[f"extra.{k}"] = v
    # tmp+rename for BOTH files: a kill mid-dump (the exact failure the
    # in-loop checkpointing targets) must leave the previous complete
    # checkpoint intact (ADVICE.md round 2)
    st_tmp = os.path.join(path, "state.npz.tmp")
    with open(st_tmp, "wb") as fh:
        np.savez(fh, **tensors)
    os.replace(st_tmp, os.path.join(path, "state.npz"))
    tmp = os.path.join(path, "manifest.json.tmp")
    with open(tmp, "w") as fh:
        json.dump(manifest, fh, indent=1)
    os.replace(tmp, os.path.join(path, "manifest.json"))  # atomic commit


def load_checkpoint(path: str) -> dict:
    """Load optimizer state → dict with cameras/points (numpy) + manifest."""
    with np.load(os.path.join(path, "state.npz"), allow_pickle=False) as z:
        tensors = {k: z[k] for k in z.files}
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    out = dict(manifest)
    out["cameras"] = tensors["cameras"]
    out["points"] = tensors["points"]
    out["extra_tensors"] = {k[6:]: v for k, v in tensors.items()
                            if k.startswith("extra.")}
    return out
