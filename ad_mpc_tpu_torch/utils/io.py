"""Dataset and model IO with metadata-keyed directories.

Port of ``ad_mpc_tpu/utils/io.py``: datasets live under
``<data root>/<name>/<split>/v<k>/`` keyed by a ``meta.json`` dict, fitted
models under ``<results root>/model_fitting/<git hash>/<model name>/``,
so that a model traces to the code that made it. Arrays are ``.npz``.

The port keeps its own roots, so that it never writes over the JAX
package's committed results: ``results/torch`` and ``data/torch`` of the
repo, or the directories named by ``AD_MPC_TORCH_RESULTS_DIR`` and
``AD_MPC_TORCH_DATA_DIR``, or a ``root`` argument. A model is saved as an
``.npz`` in the layout of ``convert.save_gp_ensemble`` (a
:class:`~ad_mpc_tpu_torch.learned.ensemble.GPEnsemble`, read back by
``ensemble.load_npz``) or as one array (an RDRv drag matrix); nothing is
pickled.
"""

from __future__ import annotations

import json
import os
import subprocess
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]


def results_root() -> str:
    """The port's results root: ``$AD_MPC_TORCH_RESULTS_DIR`` or
    ``results/torch`` of the repo."""
    return os.environ.get("AD_MPC_TORCH_RESULTS_DIR",
                          str(REPO / "results" / "torch"))


def data_root() -> str:
    """The port's dataset root: ``$AD_MPC_TORCH_DATA_DIR`` or
    ``data/torch`` of the repo."""
    return os.environ.get("AD_MPC_TORCH_DATA_DIR", str(REPO / "data" / "torch"))


def git_hash(short: bool = True) -> str:
    """The repo's git hash (the model registry's key), or ``nogit`` where
    there is no repository or no git."""
    try:
        cmd = ["git", "rev-parse"] + (["--short"] if short else []) + ["HEAD"]
        out = subprocess.run(cmd, capture_output=True, text=True,
                             cwd=os.path.dirname(os.path.abspath(__file__)))
        h = out.stdout.strip()
        return h if h else "nogit"
    except Exception:
        return "nogit"


def _meta_matches(meta_path: str, metadata: dict) -> bool:
    try:
        with open(meta_path) as f:
            stored = json.load(f)
        return all(stored.get(k) == v for k, v in metadata.items())
    except FileNotFoundError:
        return False


def dataset_dir(name: str, split: str = "train", metadata: dict | None = None,
                create: bool = False, root: str | None = None) -> str:
    """The dataset directory whose ``meta.json`` matches ``metadata``;
    with ``create``, a new ``v<k>`` directory holding it when none does."""
    base = os.path.join(root or data_root(), name, split)
    metadata = metadata or {}
    if os.path.isdir(base):
        for sub in sorted(os.listdir(base)):
            d = os.path.join(base, sub)
            if _meta_matches(os.path.join(d, "meta.json"), metadata):
                return d
    if not create:
        raise FileNotFoundError(f"no dataset '{name}/{split}' matching {metadata}")
    idx = len(os.listdir(base)) if os.path.isdir(base) else 0
    d = os.path.join(base, f"v{idx:03d}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "meta.json"), "w") as f:
        json.dump(metadata, f, indent=1)
    return d


def save_arrays(directory: str, **arrays) -> str:
    path = os.path.join(directory, "data.npz")
    np.savez_compressed(path, **arrays)
    return path


def load_arrays(directory: str) -> dict:
    with np.load(os.path.join(directory, "data.npz")) as z:
        return {k: z[k] for k in z.files}


def model_dir(model_name: str, create: bool = False, root: str | None = None) -> str:
    """``<results root>/model_fitting/<git hash>/<model name>/``."""
    d = os.path.join(root or results_root(), "model_fitting", git_hash(), model_name)
    if create:
        os.makedirs(d, exist_ok=True)
    return d


def _is_ensemble(obj) -> bool:
    return hasattr(obj, "_fields") and "k_inv_y" in obj._fields


def save_model(obj, model_name: str, metadata: dict | None = None,
               root: str | None = None) -> str:
    """Save a fitted model as ``model.npz`` beside its ``meta.json``: a
    :class:`GPEnsemble` field by field (``convert.save_gp_ensemble``'s
    layout), anything else as one array ``value``. Returns the directory."""
    d = model_dir(model_name, create=True, root=root)
    path = os.path.join(d, "model.npz")
    if _is_ensemble(obj):
        np.savez(path, **{k: np.asarray(getattr(obj, k)) for k in obj._fields})
    else:
        np.savez(path, value=np.asarray(obj))
    if metadata:
        with open(os.path.join(d, "meta.json"), "w") as f:
            json.dump(metadata, f, indent=1)
    return d


def load_model(model_name: str, git_rev: str | None = None, root: str | None = None):
    """The model :func:`save_model` wrote under ``git_rev`` (default: this
    revision, else the newest revision that holds it)."""
    from ad_mpc_tpu_torch.learned.ensemble import load_npz

    base = os.path.join(root or results_root(), "model_fitting")
    path = os.path.join(base, git_rev or git_hash(), model_name, "model.npz")
    if not os.path.exists(path) and git_rev is None and os.path.isdir(base):
        cands = [p for r in os.listdir(base)
                 if os.path.exists(p := os.path.join(base, r, model_name, "model.npz"))]
        if cands:
            path = max(cands, key=os.path.getmtime)
    with np.load(path) as z:
        if "value" in z.files:
            return z["value"]
    return load_npz(path)
