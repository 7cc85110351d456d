"""Serve fitted models without the framework: StableHLO export.

The production serving shape: fit a synergy model once (on a GPU or
a mesh of them), then run ``transform`` on new trials from a process that has
*neither this package nor the training code* — only jax.  ``jax.export``
serializes the jitted transform program (StableHLO + calling
convention) for a fixed input signature; the artifact replays on every
platform it was lowered for, under jax's compatibility guarantees, with
the whole solver loop (the sklearn-exact multiplicative/CD updates,
stopping rule included) *inside* the artifact.

The reference has no counterpart — its transform requires a live
sklearn ``NMF`` object (reference analysis.py:848-864).

Two calls:

- :func:`export_transform` — turn a fitted
  :class:`~muscle_synergies_tpu.models.select.NMFModel` /
  :class:`~muscle_synergies_tpu.models.cnmf.CNMFModel` /
  :class:`~muscle_synergies_tpu.models.nm3f.NM3FModel` into serialized
  bytes (optionally written to disk).
- :func:`load_transform` — rehydrate the bytes into a plain
  ``fn(x) -> np.ndarray`` callable.

Batch-size polymorphism: pass a string (e.g. ``"b"``) as the leading
dimension of ``shape`` and the artifact accepts any batch size at call
time (symbolic-shape export); the solver loops and on-device inits are
shape-polymorphic.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import export as _jax_export

__all__ = ["export_transform", "load_transform"]


def _signature(shape, dtype) -> jax.ShapeDtypeStruct:
    """Build the input spec; string/None dims become symbolic."""
    if any(isinstance(d, str) or d is None for d in shape):
        spec = ",".join(
            (d if isinstance(d, str) else "_") if not isinstance(d, int)
            else str(d)
            for d in shape
        )
        shape = _jax_export.symbolic_shape(spec)
    return jax.ShapeDtypeStruct(tuple(shape), dtype)


def _transform_fn(model):
    """The pure-JAX transform core of a fitted estimator."""
    name = type(model).__name__
    if name == "NMFModel":

        def nmf_transform(x):
            # a 3-D signature serves a whole stack of trials per call
            # (one vmapped program; the batch dim may be symbolic)
            if x.ndim == 3:
                return jax.vmap(lambda xi: model._transform_jax(xi)[0])(x)
            return model._transform_jax(x)[0]

        return nmf_transform
    if name in ("CNMFModel", "NM3FModel"):
        return model._transform_jax
    raise TypeError(
        f"cannot export {name}; expected NMFModel, CNMFModel or NM3FModel"
    )


def _lower(model, shape, dtype, platforms) -> _jax_export.Exported:
    """:func:`export_transform`'s ``jax.export.Exported``, unserialized."""
    fn = _transform_fn(model)
    return _jax_export.export(jax.jit(fn), platforms=platforms)(
        _signature(shape, dtype)
    )


def export_transform(
    model,
    shape: Sequence[Union[int, str, None]],
    *,
    dtype=jnp.float32,
    platforms: Optional[Tuple[str, ...]] = ("cpu", "cuda"),
    path=None,
) -> bytes:
    """Serialize a fitted estimator's ``transform`` as StableHLO.

    Args:
        model: a fitted ``NMFModel`` / ``CNMFModel`` / ``NM3FModel``.
        shape: input signature — ``(T, L)`` for NMF/CNMF single runs,
            ``(B, T, L)`` for batched CNMF/NM3F.  String or ``None``
            entries declare symbolic (polymorphic) dimensions, e.g.
            ``("b", 200, 8)`` serves any batch size.
        dtype: input dtype baked into the artifact (default float32 —
            the production device dtype; use float64 to replay
            CPU-exact results).
        platforms: lowering targets recorded in the artifact (default
            CPU and NVIDIA GPUs, ``"cuda"``).
        path: optionally also write the bytes here, atomically.

    Returns:
        the serialized artifact bytes (``jax.export`` format, which
        needs the ``flatbuffers`` package).
    """
    exported = _lower(model, shape, dtype, platforms)
    blob = exported.serialize()
    if path is not None:
        path = Path(path)
        tmp = path.with_name(path.name + ".tmp")
        tmp.write_bytes(blob)
        os.replace(tmp, path)  # atomic publish
    return blob


def load_transform(source):
    """Rehydrate :func:`export_transform` bytes (or a file path written
    by it) into a plain ``fn(x) -> np.ndarray``.

    The returned callable carries the underlying ``jax.export.Exported``
    as ``fn.exported`` (platforms, input signature, …).  Only jax is
    needed at load time — none of this package's solver code runs.
    """
    if isinstance(source, (str, os.PathLike)):
        exported = _jax_export.deserialize(Path(source).read_bytes())
    else:
        exported = _jax_export.deserialize(bytes(source))

    def fn(x) -> np.ndarray:
        return np.asarray(exported.call(jnp.asarray(x)))

    fn.exported = exported
    return fn
