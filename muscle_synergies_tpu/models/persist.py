"""Pickle-free persistence for fitted synergy models.

Production deployments fit a synergy library once (through the batched
or mesh-sharded solvers) and serve ``transform`` /
``inverse_transform`` later, often on a different host.  The reference
has no persistence surface at all — its fitted sklearn ``NMF`` objects
inside ``SynergyRunResult.model`` (reference analysis.py:713-914) must
be pickled, which ties the artifact to the Python/sklearn build and
executes arbitrary code at load time.  This module stores models as a
single compressed ``.npz``: numeric arrays plus one JSON metadata
string, loaded with ``allow_pickle=False`` — safe on untrusted files
and independent of jax/sklearn internals.

Formats:

- ``muscle_synergies_tpu.model/1``: one fitted estimator
  (:class:`~muscle_synergies_tpu.models.select.NMFModel`,
  :class:`~muscle_synergies_tpu.models.cnmf.CNMFModel` or
  :class:`~muscle_synergies_tpu.models.nm3f.NM3FModel`).  The npz holds
  ``__meta__`` (JSON: format tag, class name, constructor params,
  scalar fitted attributes) plus one entry per fitted array.
- ``muscle_synergies_tpu.synergy_run/1``: a whole
  :class:`~muscle_synergies_tpu.models.select.SynergyRunResult` (single
  run or rank sweep) — the VAF table, per-rank component DataFrames and
  one embedded model payload per rank.

Round-trip guarantee: a loaded model's ``transform`` /
``inverse_transform`` reproduce the original bit-for-bit (the fitted
factors are stored at full precision and the solver hyperparameters are
restored exactly, including the legacy sklearn<=0.24 ``alpha`` /
``regularization`` spelling).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
from .._optional import pandas

__all__ = [
    "MODEL_FORMAT",
    "RUN_FORMAT",
    "load_model",
    "load_synergy_run",
    "save_model",
    "save_synergy_run",
]

MODEL_FORMAT = "muscle_synergies_tpu.model/1"
RUN_FORMAT = "muscle_synergies_tpu.synergy_run/1"

_Payload = Tuple[Dict[str, np.ndarray], Dict[str, Any]]


def _precision_token(precision) -> Union[str, None]:
    """JSON-portable spelling of a matmul ``precision`` knob.

    Accepts ``None``, the string spellings every jnp API takes
    (``"default"`` / ``"high"`` / ``"highest"``), or a
    ``jax.lax.Precision`` member (stored by its lowercase name, which
    jnp APIs accept back).
    """
    if precision is None or isinstance(precision, str):
        return precision
    name = getattr(precision, "name", None)
    if isinstance(name, str):
        return name.lower()
    raise TypeError(
        "precision must be None, a string, or a jax.lax.Precision "
        f"member to be persisted; got {precision!r}"
    )


def _require_fitted(model, attr: str, cls: str) -> None:
    if not hasattr(model, attr):
        raise ValueError(
            f"this {cls} instance is not fitted yet; fit before saving"
        )


# ---------------------------------------------------------------------------
# Per-class payloads: (arrays, meta) <-> estimator


def _nmf_payload(model) -> _Payload:
    _require_fitted(model, "components_", "NMFModel")
    params = {
        "n_components": model.n_components,
        "solver": model.solver,
        "beta_loss": model.beta_loss,
        "init": model.init,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "random_state": model.random_state,
        "alpha_W": model.alpha_W,
        "alpha_H": model.alpha_H,
        "l1_ratio": model.l1_ratio,
        "svd_method": model.svd_method,
        "inner_iter": model.inner_iter,
        # the sklearn<=0.24 spelling is resolved at __init__ into this
        # pair; persist it directly so loaded models transform with the
        # same (unscaled) penalties
        "legacy_alpha": (
            list(model._legacy_alpha) if model._legacy_alpha else None
        ),
    }
    fitted = {
        "n_components_": int(model.n_components_),
        "n_iter_": int(model.n_iter_),
        "reconstruction_err_": float(model.reconstruction_err_),
    }
    arrays = {"components_": np.asarray(model.components_)}
    return arrays, {"class": "NMFModel", "params": params, "fitted": fitted}


def _nmf_restore(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any]):
    from .select import NMFModel

    params = dict(meta["params"])
    legacy = params.pop("legacy_alpha", None)
    model = NMFModel(**params)
    if legacy is not None:
        model._legacy_alpha = (float(legacy[0]), legacy[1])
    model.components_ = np.asarray(arrays["components_"])
    for key, value in meta["fitted"].items():
        setattr(model, key, value)
    return model


def _cnmf_payload(model) -> _Payload:
    _require_fitted(model, "synergies_", "CNMFModel")
    params = {
        "n_components": model.n_components,
        "n_lags": model.n_lags,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "n_inits": model.n_inits,
        "random_state": model.random_state,
        "impl": model.impl,
        "precision": _precision_token(model.precision),
    }
    fitted = {
        "n_components_": int(model.n_components_),
        "n_lags_": int(model.n_lags_),
        "n_iter_": int(model.n_iter_),
        "reconstruction_err_": float(model.reconstruction_err_),
    }
    arrays = {
        "synergies_": np.asarray(model.synergies_),
        "restart_errors_": np.asarray(model.restart_errors_),
    }
    return arrays, {"class": "CNMFModel", "params": params, "fitted": fitted}


def _cnmf_restore(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any]):
    from .cnmf import CNMFModel

    params = dict(meta["params"])
    model = CNMFModel(params.pop("n_components"), params.pop("n_lags"),
                      **params)
    model.synergies_ = np.asarray(arrays["synergies_"])
    model.restart_errors_ = np.asarray(arrays["restart_errors_"])
    for key, value in meta["fitted"].items():
        setattr(model, key, value)
    return model


def _nm3f_payload(model) -> _Payload:
    _require_fitted(model, "temporal_modules_", "NM3FModel")
    params = {
        "n_temporal": model.n_temporal,
        "n_spatial": model.n_spatial,
        "tol": model.tol,
        "max_iter": model.max_iter,
        "n_inits": model.n_inits,
        "random_state": model.random_state,
        "precision": _precision_token(model.precision),
    }
    fitted = {
        "n_temporal_": int(model.n_temporal_),
        "n_spatial_": int(model.n_spatial_),
        "n_iter_": int(model.n_iter_),
        "reconstruction_err_": float(model.reconstruction_err_),
        "vaf_": float(model.vaf_),
    }
    arrays = {
        "temporal_modules_": np.asarray(model.temporal_modules_),
        "spatial_modules_": np.asarray(model.spatial_modules_),
        "restart_errors_": np.asarray(model.restart_errors_),
    }
    return arrays, {"class": "NM3FModel", "params": params, "fitted": fitted}


def _nm3f_restore(arrays: Mapping[str, np.ndarray], meta: Mapping[str, Any]):
    from .nm3f import NM3FModel

    params = dict(meta["params"])
    model = NM3FModel(params.pop("n_temporal"), params.pop("n_spatial"),
                      **params)
    model.temporal_modules_ = np.asarray(arrays["temporal_modules_"])
    model.spatial_modules_ = np.asarray(arrays["spatial_modules_"])
    model.restart_errors_ = np.asarray(arrays["restart_errors_"])
    for key, value in meta["fitted"].items():
        setattr(model, key, value)
    return model


def _registry():
    # resolved lazily so persist never forces the solver modules at
    # import time (they pull jax)
    return {
        "NMFModel": (_nmf_payload, _nmf_restore),
        "CNMFModel": (_cnmf_payload, _cnmf_restore),
        "NM3FModel": (_nm3f_payload, _nm3f_restore),
    }


def _model_payload(model) -> _Payload:
    name = type(model).__name__
    reg = _registry()
    if name not in reg:
        raise TypeError(
            f"cannot persist {name}; expected one of {sorted(reg)}"
        )
    return reg[name][0](model)


def _model_restore(arrays: Mapping[str, np.ndarray],
                   meta: Mapping[str, Any]):
    reg = _registry()
    name = meta.get("class")
    if name not in reg:
        raise ValueError(f"unknown model class in payload: {name!r}")
    return reg[name][1](arrays, meta)


# ---------------------------------------------------------------------------
# npz plumbing


def _normalize_path(path) -> Path:
    path = Path(path)
    if path.suffix != ".npz":
        path = path.with_name(path.name + ".npz")
    return path


def _atomic_savez(path: Path, arrays: Dict[str, np.ndarray],
                  meta: Dict[str, Any]) -> Path:
    payload = dict(arrays)
    payload["__meta__"] = np.array(json.dumps(meta))
    tmp = path.with_suffix(".tmp.npz")
    np.savez_compressed(tmp, **payload)
    os.replace(tmp, path)  # atomic publish
    return path


def _load_npz(path, expected_format: str):
    path = Path(path)
    with np.load(path, allow_pickle=False) as data:
        if "__meta__" not in data.files:
            raise ValueError(f"{path} is not a muscle_synergies_tpu payload")
        meta = json.loads(str(data["__meta__"]))
        if meta.get("format") != expected_format:
            raise ValueError(
                f"{path}: format {meta.get('format')!r}, expected "
                f"{expected_format!r}"
            )
        arrays = {
            key: np.asarray(data[key])
            for key in data.files
            if key != "__meta__"
        }
    return arrays, meta


# ---------------------------------------------------------------------------
# Public surface


def save_model(model, path) -> Path:
    """Persist a fitted estimator to ``path`` (``.npz`` appended if
    missing), atomically.  Returns the path written."""
    arrays, meta = _model_payload(model)
    meta = dict(meta, format=MODEL_FORMAT)
    return _atomic_savez(_normalize_path(path), arrays, meta)


def load_model(path):
    """Load an estimator saved by :func:`save_model`.

    The file is read with ``allow_pickle=False`` — no code executes at
    load time, so untrusted model files are safe to open.
    """
    arrays, meta = _load_npz(path, MODEL_FORMAT)
    return _model_restore(arrays, meta)


def save_synergy_run(result, path) -> Path:
    """Persist a :class:`SynergyRunResult` (single run or rank sweep).

    Stores the VAF table, every rank's component DataFrame (with its
    muscle-name columns) and every fitted model, so a reloaded sweep
    supports the same rank selection + ``transform`` workflow the
    reference drives from ``find_synergies``'s return value.
    """
    sweep = isinstance(result.model, Mapping)
    arrays: Dict[str, np.ndarray] = {
        "vaf_values": result.vaf_values.to_numpy()
    }
    meta: Dict[str, Any] = {
        "format": RUN_FORMAT,
        "sweep": sweep,
        "vaf_columns": [str(c) for c in result.vaf_values.columns],
        "vaf_index": [int(i) for i in result.vaf_values.index],
    }
    if sweep:
        ranks = sorted(int(k) for k in result.model)
        meta["ranks"] = ranks
        meta["models"] = {}
        meta["components_columns"] = {}
        for rank in ranks:
            comp = result.components[rank]
            arrays[f"components__{rank}"] = comp.to_numpy()
            meta["components_columns"][str(rank)] = [
                str(c) for c in comp.columns
            ]
            model_arrays, model_meta = _model_payload(result.model[rank])
            for key, value in model_arrays.items():
                arrays[f"model__{rank}__{key}"] = value
            meta["models"][str(rank)] = model_meta
    else:
        arrays["components__"] = result.components.to_numpy()
        meta["components_columns"] = [
            str(c) for c in result.components.columns
        ]
        model_arrays, model_meta = _model_payload(result.model)
        for key, value in model_arrays.items():
            arrays[f"model____{key}"] = value
        meta["model"] = model_meta
    return _atomic_savez(_normalize_path(path), arrays, meta)


def load_synergy_run(path):
    """Load a :class:`SynergyRunResult` saved by
    :func:`save_synergy_run` (``allow_pickle=False``; safe on
    untrusted files)."""
    from .select import SynergyRunResult

    arrays, meta = _load_npz(path, RUN_FORMAT)
    vaf_values = pandas.DataFrame(
        arrays["vaf_values"],
        columns=meta["vaf_columns"],
        index=meta["vaf_index"],
    )
    if meta["sweep"]:
        components: Dict[int, pandas.DataFrame] = {}
        models: Dict[int, Any] = {}
        for rank in meta["ranks"]:
            components[rank] = pandas.DataFrame(
                arrays[f"components__{rank}"],
                columns=meta["components_columns"][str(rank)],
            )
            prefix = f"model__{rank}__"
            model_arrays = {
                key[len(prefix):]: value
                for key, value in arrays.items()
                if key.startswith(prefix)
            }
            models[rank] = _model_restore(
                model_arrays, meta["models"][str(rank)]
            )
        return SynergyRunResult(vaf_values, components, models)
    components = pandas.DataFrame(
        arrays["components__"], columns=meta["components_columns"]
    )
    prefix = "model____"
    model_arrays = {
        key[len(prefix):]: value
        for key, value in arrays.items()
        if key.startswith(prefix)
    }
    model = _model_restore(model_arrays, meta["model"])
    return SynergyRunResult(vaf_values, components, model)
