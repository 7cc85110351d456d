"""Factor checkpointing and rank-sweep resume.

The reference keeps everything in memory and persists nothing (SURVEY
§5 "checkpoint/resume": absent).  Here every completed rank of a sweep
saves its factors, VAF table and solver telemetry so long multi-rank /
multi-trial jobs restart from completed work.  Two interchangeable
backends:

- ``"npz"`` (default): one compressed npz per rank, atomically
  published — zero extra dependencies, right for single-host runs;
- ``"orbax"``: one orbax checkpoint directory per rank (PyTree arrays
  + JSON metadata via a composite handler) — the multi-host path,
  since orbax coordinates saves of sharded ``jax.Array`` factors
  across processes and storage backends.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping, Optional, Union

import numpy as np
from .._optional import pandas

__all__ = [
    "SweepCheckpoint",
    "GridCheckpoint",
    "find_synergies_checkpointed",
]


class SweepCheckpoint:
    """Directory-backed store of per-rank factorization results.

    Layout: ``<dir>/rank_<k>.npz`` (npz backend) or ``<dir>/rank_<k>/``
    (orbax backend), holding arrays ``w``, ``h``, ``vaf`` plus metadata
    (VAF columns, iterations, loss).  The two backends share the same
    ``save``/``load``/``has``/``completed_ranks`` surface.
    """

    def __init__(
        self, directory: Union[str, os.PathLike], backend: str = "npz"
    ):
        if backend not in ("npz", "orbax"):
            raise ValueError(
                f"backend must be 'npz' or 'orbax', got {backend!r}"
            )
        self.backend = backend
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    def _path(self, rank: int) -> Path:
        suffix = ".npz" if self.backend == "npz" else ""
        return self.directory / f"rank_{rank}{suffix}"

    def completed_ranks(self):
        pattern = "rank_*.npz" if self.backend == "npz" else "rank_*"
        ranks = []
        for p in self.directory.glob(pattern):
            if self.backend == "orbax" and not p.is_dir():
                continue
            try:
                ranks.append(int(p.stem.split("_")[1]))
            except (IndexError, ValueError):
                continue
        return sorted(ranks)

    def has(self, rank: int) -> bool:
        return self._path(rank).exists()

    def save(
        self,
        rank: int,
        w: np.ndarray,
        h: np.ndarray,
        vaf_values: pandas.DataFrame,
        meta: Optional[Mapping] = None,
    ):
        if self.backend == "orbax":
            return self._save_orbax(rank, w, h, vaf_values, meta)
        tmp = self._path(rank).with_suffix(".tmp.npz")
        np.savez_compressed(
            tmp,
            w=np.asarray(w),
            h=np.asarray(h),
            vaf=vaf_values.to_numpy(),
            vaf_columns=np.array(list(vaf_values.columns), dtype=object),
            meta=np.array(json.dumps(dict(meta or {})), dtype=object),
        )
        os.replace(tmp, self._path(rank))  # atomic publish

    def load(self, rank: int) -> Dict:
        if self.backend == "orbax":
            return self._load_orbax(rank)
        with np.load(self._path(rank), allow_pickle=True) as data:
            vaf = pandas.DataFrame(
                data["vaf"], columns=list(data["vaf_columns"])
            )
            return {
                "w": data["w"],
                "h": data["h"],
                "vaf_values": vaf,
                "meta": json.loads(str(data["meta"])),
            }

    # -- orbax backend -------------------------------------------------------
    @staticmethod
    def _orbax():
        try:
            import orbax.checkpoint as ocp
        except ImportError as exc:  # pragma: no cover - orbax is bundled
            raise ImportError(
                "the 'orbax' checkpoint backend needs orbax-checkpoint"
            ) from exc
        return ocp

    def _save_orbax(self, rank, w, h, vaf_values, meta):
        ocp = self._orbax()
        path = self._path(rank).resolve()
        arrays = {
            "w": np.asarray(w),
            "h": np.asarray(h),
            "vaf": vaf_values.to_numpy(),
        }
        payload = {
            "vaf_columns": [str(c) for c in vaf_values.columns],
            "meta": dict(meta or {}),
        }
        with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as cp:
            # orbax publishes atomically (tmp dir + rename) on its own
            cp.save(
                path,
                args=ocp.args.Composite(
                    arrays=ocp.args.PyTreeSave(arrays),
                    meta=ocp.args.JsonSave(payload),
                ),
                force=True,
            )

    def _load_orbax(self, rank) -> Dict:
        ocp = self._orbax()
        path = self._path(rank).resolve()
        with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as cp:
            out = cp.restore(
                path,
                args=ocp.args.Composite(
                    arrays=ocp.args.PyTreeRestore(),
                    meta=ocp.args.JsonRestore(),
                ),
            )
        arrays, payload = out["arrays"], out["meta"]
        vaf = pandas.DataFrame(
            np.asarray(arrays["vaf"]), columns=payload["vaf_columns"]
        )
        return {
            "w": np.asarray(arrays["w"]),
            "h": np.asarray(arrays["h"]),
            "vaf_values": vaf,
            "meta": payload["meta"],
        }


class GridCheckpoint:
    """String-keyed directory store of intermediate sweep results.

    The generalization of :class:`SweepCheckpoint` the long-running
    jobs need (cNMF/NM3F module-count selection, bootstrap stability,
    Wold CV — see :mod:`muscle_synergies_tpu.models.resume`): each
    unit of work saves an arbitrary mapping of named arrays plus JSON
    metadata under a caller-chosen key.  Layout: ``<dir>/<key>.npz``
    (npz backend, atomically published) or ``<dir>/<key>/`` (orbax).

    Keys may contain only word characters and dashes so they stay
    valid cross-platform file names.
    """

    _KEY_RE = None  # compiled lazily

    def __init__(
        self, directory: Union[str, os.PathLike], backend: str = "npz"
    ):
        if backend not in ("npz", "orbax"):
            raise ValueError(
                f"backend must be 'npz' or 'orbax', got {backend!r}"
            )
        self.backend = backend
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)

    @classmethod
    def _check_key(cls, key: str) -> str:
        import re

        if cls._KEY_RE is None:
            cls._KEY_RE = re.compile(r"^[\w\-]+$")
        if not cls._KEY_RE.match(key):
            raise ValueError(
                f"checkpoint key must match [\\w-]+, got {key!r}"
            )
        return key

    def _path(self, key: str) -> Path:
        suffix = ".npz" if self.backend == "npz" else ""
        return self.directory / f"{self._check_key(key)}{suffix}"

    def completed_keys(self):
        pattern = "*.npz" if self.backend == "npz" else "*"
        keys = []
        for p in self.directory.glob(pattern):
            if self.backend == "orbax" and not p.is_dir():
                continue
            if p.name.endswith(".tmp.npz"):
                continue
            keys.append(p.stem if self.backend == "npz" else p.name)
        return sorted(keys)

    def has(self, key: str) -> bool:
        return self._path(key).exists()

    def save(
        self,
        key: str,
        arrays: Mapping[str, np.ndarray],
        meta: Optional[Mapping] = None,
    ):
        payload = {k: np.asarray(v) for k, v in arrays.items()}
        if any(k == "meta" for k in payload):
            raise ValueError("'meta' is a reserved array name")
        if self.backend == "orbax":
            ocp = SweepCheckpoint._orbax()
            path = self._path(key).resolve()
            with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as cp:
                cp.save(
                    path,
                    args=ocp.args.Composite(
                        arrays=ocp.args.PyTreeSave(payload),
                        meta=ocp.args.JsonSave(dict(meta or {})),
                    ),
                    force=True,
                )
            return
        tmp = self._path(key).with_suffix(".tmp.npz")
        np.savez_compressed(
            tmp,
            meta=np.array(json.dumps(dict(meta or {})), dtype=object),
            **payload,
        )
        os.replace(tmp, self._path(key))  # atomic publish

    def load(self, key: str) -> Dict:
        if self.backend == "orbax":
            ocp = SweepCheckpoint._orbax()
            path = self._path(key).resolve()
            with ocp.Checkpointer(ocp.CompositeCheckpointHandler()) as cp:
                out = cp.restore(
                    path,
                    args=ocp.args.Composite(
                        arrays=ocp.args.PyTreeRestore(),
                        meta=ocp.args.JsonRestore(),
                    ),
                )
            return {
                "arrays": {
                    k: np.asarray(v) for k, v in out["arrays"].items()
                },
                "meta": dict(out["meta"]),
            }
        with np.load(self._path(key), allow_pickle=True) as data:
            return {
                "arrays": {
                    k: data[k] for k in data.files if k != "meta"
                },
                "meta": json.loads(str(data["meta"])),
            }


def find_synergies_checkpointed(
    processed_emg_df: pandas.DataFrame,
    n_components: int,
    max_components: int,
    checkpoint_dir: Union[str, os.PathLike],
    *,
    max_iter: int = 100_000,
    tol: float = 1e-6,
    backend: str = "npz",
    **nmf_kwargs,
):
    """Rank sweep that resumes from previously completed ranks.

    Ranks already present in ``checkpoint_dir`` are loaded instead of
    re-fit; every newly fitted rank is saved before moving on.  Returns
    the same :class:`~muscle_synergies_tpu.models.SynergyRunResult`
    shape as ``find_synergies`` (with ``model`` holding per-rank
    metadata dicts for restored ranks).  ``backend`` selects the
    :class:`SweepCheckpoint` storage format (``"npz"`` or ``"orbax"``).
    """
    from collections import OrderedDict

    from ..analysis import vaf as _vaf
    from ..models import NMFModel
    from ..models.select import SynergyRunResult

    # same validation surface as find_synergies (select.py)
    if processed_emg_df.empty:
        raise ValueError("empty EMG DataFrame")
    num_features = len(processed_emg_df.columns)
    if (
        n_components < 1
        or n_components > num_features
        or max_components < n_components
        or max_components > num_features
    ):
        raise ValueError("invalid number of components")

    ckpt = SweepCheckpoint(checkpoint_dir, backend=backend)
    runs = OrderedDict()
    for k in range(n_components, max_components + 1):
        if ckpt.has(k):
            stored = ckpt.load(k)
            comps = pandas.DataFrame(
                stored["h"], columns=processed_emg_df.columns
            )
            runs[k] = SynergyRunResult(
                stored["vaf_values"], comps, stored["meta"]
            )
            continue
        model = NMFModel(n_components=k, max_iter=max_iter, tol=tol, **nmf_kwargs)
        w = model.fit_transform(processed_emg_df)
        vaf_values = _vaf(
            processed_emg_df,
            components=model.components_,
            transformed_signal=w,
        )
        comps = pandas.DataFrame(
            model.components_, columns=processed_emg_df.columns
        )
        ckpt.save(
            k,
            w,
            model.components_,
            vaf_values,
            meta={
                "n_iter": model.n_iter_,
                "reconstruction_err": model.reconstruction_err_,
                "solver": getattr(model, "solver", "cd"),
            },
        )
        runs[k] = SynergyRunResult(vaf_values, comps, model)

    vaf_values = pandas.concat([r.vaf_values for r in runs.values()])
    vaf_values.set_index(np.array(tuple(runs.keys())), inplace=True)
    return SynergyRunResult(
        vaf_values,
        {k: r.components for k, r in runs.items()},
        {k: r.model for k, r in runs.items()},
    )
