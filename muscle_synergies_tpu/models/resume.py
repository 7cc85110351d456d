"""Checkpoint/resume drivers for the long-running sweeps.

The reference persists nothing (SURVEY §5 "checkpoint/resume":
absent); round 2 added rank-sweep resume for the spatial model
(:func:`~muscle_synergies_tpu.utils.checkpoint.find_synergies_checkpointed`).
This module generalizes it to the jobs that actually run long at
dataset scale — bootstrap stability and Wold cross-validation for
every model family (spatial, convolutive, space-by-time and the
shared-factor tMod/sMod specializations):

- the ``bootstrap_*_checkpointed`` drivers split the resample batch
  into chunks; every finished chunk's similarities publish atomically
  to a :class:`~muscle_synergies_tpu.utils.checkpoint.GridCheckpoint`
  before the next chunk starts, and a restarted job reloads completed
  chunks instead of refitting them;
- the ``cv_*_checkpointed`` drivers run the candidate grid one
  candidate at a time (each candidate still one vmapped device solve
  over its repeats), saving each candidate's held-out error column.

Both compose to their one-shot counterparts: the resample index draws
are made once up front and handed to the underlying functions (their
private ``_resample_plan`` seam, which also offsets the per-resample
init seeds), so each chunk fits exactly the resamples the unchunked
call would.  The numerics match the one-shot call to float-reordering
tolerance, not bit-for-bit: a chunk's batch dimension differs from
``n_boot``, which changes XLA's batched-GEMM blocking, and resamples
that have not converged by ``max_iter`` amplify those ~1-ulp
differences over the multiplicative updates (observed ~1e-7 at f64 on
non-converged rows; rows that converge match exactly).  The CV mask
draws depend only on ``(seed, n_repeats, holdout_fraction)`` so they
are identical across per-candidate calls, and the grids' zero-padding
is exact by construction (padded modules start at zero and stay zero)
— but the one-shot grid pads every candidate to the GRID maximum,
which reorders float reductions the same way.  Parity tests in
``tests/test_resume.py`` pin both (1e-6 on bootstrap similarities,
1e-12 relative on CV error columns).

Each checkpoint directory belongs to ONE job: the stored chunks are
keyed by position, so changing the data or parameters between runs
without clearing the directory composes stale results (same contract
as ``find_synergies_checkpointed``).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import numpy as np

from ..utils.checkpoint import GridCheckpoint
from .stability import (
    BootstrapResult,
    CVResult,
    SpaceByTimeCVResult,
    TimeVaryingBootstrapResult,
    _block_bootstrap_indices,
    bootstrap_shared_spatial_synergies,
    bootstrap_space_by_time,
    bootstrap_synergies,
    bootstrap_temporal_synergies,
    bootstrap_time_varying_synergies,
    cv_rank_selection,
    cv_space_by_time_selection,
    cv_time_varying_rank_selection,
)

__all__ = [
    "bootstrap_synergies_checkpointed",
    "bootstrap_time_varying_synergies_checkpointed",
    "bootstrap_space_by_time_checkpointed",
    "bootstrap_temporal_synergies_checkpointed",
    "bootstrap_shared_spatial_synergies_checkpointed",
    "cv_rank_selection_checkpointed",
    "cv_time_varying_rank_selection_checkpointed",
    "cv_space_by_time_selection_checkpointed",
]

_PathLike = Union[str, os.PathLike]


def _chunks(n_total: int, chunk_size: int):
    if chunk_size < 1:
        raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
    return [
        (lo, min(lo + chunk_size, n_total))
        for lo in range(0, n_total, chunk_size)
    ]


def _run_boot_chunks(
    ckpt: GridCheckpoint,
    idx: np.ndarray,
    chunk_size: int,
    run_chunk,
    sim_names: Sequence[str],
):
    """Drive chunks of a resample plan through ``run_chunk``.

    ``run_chunk(rows, lo)`` returns a result whose ``sim_names``
    attributes are per-resample arrays; completed chunks are loaded,
    missing ones computed and saved.  Returns the concatenated arrays
    (one per name) plus the last live result (for reference factors;
    ``None`` when every chunk was restored).
    """
    n_boot = idx.shape[0]
    parts = {name: [] for name in sim_names}
    live = None
    for lo, hi in _chunks(n_boot, chunk_size):
        key = f"chunk_{lo:05d}_{hi:05d}"
        if ckpt.has(key):
            stored = ckpt.load(key)["arrays"]
            for name in sim_names:
                parts[name].append(stored[name])
            continue
        live = run_chunk(idx[lo:hi], lo)
        arrays = {}
        for name, value in zip(sim_names, live if isinstance(live, tuple)
                               else (live,)):
            arrays[name] = np.asarray(value.similarities)
            parts[name].append(arrays[name])
        ckpt.save(key, arrays, meta={"range": [int(lo), int(hi)]})
    return {n: np.concatenate(p, axis=0) for n, p in parts.items()}, live


def bootstrap_synergies_checkpointed(
    x,
    n_components: int,
    checkpoint_dir: _PathLike,
    n_boot: int = 50,
    chunk_size: int = 10,
    seed: int = 0,
    backend: str = "npz",
    **kwargs,
) -> BootstrapResult:
    """:func:`~...models.stability.bootstrap_synergies` with resume.

    Resamples run in chunks of ``chunk_size`` (each chunk one vmapped
    device solve); completed chunks restore from ``checkpoint_dir``.
    The result matches the one-shot call with the same arguments to
    float-reordering tolerance (see the module docstring).  ``kwargs``
    forward to the underlying function (``init``, ``max_iter``,
    ``tol``, ``mesh``).
    """
    x_np = np.asarray(x, dtype=float)
    n = x_np.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, n, size=(n_boot, n))  # the one-shot draw

    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return bootstrap_synergies(
            x_np, n_components, seed=seed,
            _resample_plan=(rows, lo), **kwargs,
        )

    sims, live = _run_boot_chunks(ckpt, idx, chunk_size, run, ["sims"])
    if live is None:  # fully restored: recompute the cheap reference fit
        live = run(idx[:1], 0)
    return BootstrapResult(
        reference_components=live.reference_components,
        similarities=sims["sims"],
    )


def bootstrap_time_varying_synergies_checkpointed(
    x,
    n_synergies: int,
    n_lags: int,
    checkpoint_dir: _PathLike,
    n_boot: int = 50,
    chunk_size: int = 10,
    block_len: Optional[int] = None,
    seed: int = 0,
    backend: str = "npz",
    **kwargs,
) -> TimeVaryingBootstrapResult:
    """:func:`~...models.stability.bootstrap_time_varying_synergies`
    with chunked resume (the convolutive family's stability job is the
    slowest of the stability jobs)."""
    x_np = np.asarray(x, dtype=float)
    n = x_np.shape[0]
    if block_len is None:
        block_len = min(max(4 * n_lags, 16), n)  # the one-shot default
    rng = np.random.default_rng(seed)
    idx = _block_bootstrap_indices(n, block_len, n_boot, rng)

    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return bootstrap_time_varying_synergies(
            x_np, n_synergies, n_lags, block_len=block_len, seed=seed,
            _resample_plan=(rows, lo), **kwargs,
        )

    sims, live = _run_boot_chunks(ckpt, idx, chunk_size, run, ["sims"])
    if live is None:
        live = run(idx[:1], 0)
    return TimeVaryingBootstrapResult(
        reference_synergies=live.reference_synergies,
        similarities=sims["sims"],
    )


def bootstrap_space_by_time_checkpointed(
    xs,
    n_temporal: int,
    n_spatial: int,
    checkpoint_dir: _PathLike,
    n_boot: int = 50,
    chunk_size: int = 10,
    seed: int = 0,
    backend: str = "npz",
    **kwargs,
) -> Tuple[BootstrapResult, BootstrapResult]:
    """:func:`~...models.stability.bootstrap_space_by_time` with
    chunked resume; returns the (temporal, spatial) pair."""
    xs_np = np.asarray(xs, dtype=float)
    b = xs_np.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, b, size=(n_boot, b))

    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return bootstrap_space_by_time(
            xs_np, n_temporal, n_spatial, seed=seed,
            _resample_plan=(rows, lo), **kwargs,
        )

    sims, live = _run_boot_chunks(
        ckpt, idx, chunk_size, run, ["sims_w", "sims_s"]
    )
    if live is None:
        live = run(idx[:1], 0)
    ref_w, ref_s = live
    return (
        BootstrapResult(ref_w.reference_components, sims["sims_w"]),
        BootstrapResult(ref_s.reference_components, sims["sims_s"]),
    )


def _shared_factor_checkpointed(fn, xs, k, checkpoint_dir, n_boot,
                                chunk_size, seed, backend, kwargs):
    xs_np = np.asarray(xs, dtype=float)
    b = xs_np.shape[0]
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, b, size=(n_boot, b))

    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)

    def run(rows, lo):
        return fn(
            xs_np, k, seed=seed, _resample_plan=(rows, lo), **kwargs
        )

    sims, live = _run_boot_chunks(ckpt, idx, chunk_size, run, ["sims"])
    if live is None:
        live = run(idx[:1], 0)
    return BootstrapResult(live.reference_components, sims["sims"])


def bootstrap_temporal_synergies_checkpointed(
    xs, n_temporal: int, checkpoint_dir: _PathLike, n_boot: int = 50,
    chunk_size: int = 10, seed: int = 0, backend: str = "npz", **kwargs,
) -> BootstrapResult:
    """tMod bootstrap with chunked resume."""
    return _shared_factor_checkpointed(
        bootstrap_temporal_synergies, xs, n_temporal, checkpoint_dir,
        n_boot, chunk_size, seed, backend, kwargs,
    )


def bootstrap_shared_spatial_synergies_checkpointed(
    xs, n_spatial: int, checkpoint_dir: _PathLike, n_boot: int = 50,
    chunk_size: int = 10, seed: int = 0, backend: str = "npz", **kwargs,
) -> BootstrapResult:
    """sMod bootstrap with chunked resume."""
    return _shared_factor_checkpointed(
        bootstrap_shared_spatial_synergies, xs, n_spatial, checkpoint_dir,
        n_boot, chunk_size, seed, backend, kwargs,
    )


# ---------------------------------------------------------------------------
# Wold CV / module-count selections with per-candidate resume
# ---------------------------------------------------------------------------

def _run_cv_candidates(ckpt, keys, run_one):
    """Per-candidate columns, restored where complete."""
    cols = []
    for key, cand in keys:
        if ckpt.has(key):
            cols.append(ckpt.load(key)["arrays"]["test_error"])
            continue
        col = run_one(cand)  # (n_repeats, 1)
        ckpt.save(key, {"test_error": col}, meta={"candidate": cand})
        cols.append(col)
    return np.concatenate(cols, axis=1)


def cv_rank_selection_checkpointed(
    x,
    ranks: Sequence[int],
    checkpoint_dir: _PathLike,
    backend: str = "npz",
    **kwargs,
) -> CVResult:
    """:func:`~...models.stability.cv_rank_selection` with
    per-candidate resume.

    Each rank runs as its own vmapped solve over the repeats and its
    held-out error column publishes before the next rank starts; the
    composition is exact because the holdout masks depend only on
    ``(seed, n_repeats)`` and each rank's inits only on its own
    ``seed + repeat``.  ``kwargs`` forward to the one-shot function.
    """
    ranks = tuple(int(k) for k in ranks)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)
    keys = [(f"rank_{k}", k) for k in ranks]
    test_error = _run_cv_candidates(
        ckpt, keys,
        lambda k: cv_rank_selection(x, [k], **kwargs).test_error,
    )
    best = int(ranks[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(ranks, test_error, best)


def cv_time_varying_rank_selection_checkpointed(
    x,
    ranks: Sequence[int],
    n_lags: int,
    checkpoint_dir: _PathLike,
    backend: str = "npz",
    **kwargs,
) -> CVResult:
    """Convolutive synergy-count selection with per-candidate resume."""
    ranks = tuple(int(k) for k in ranks)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)
    keys = [(f"rank_{k}", k) for k in ranks]
    test_error = _run_cv_candidates(
        ckpt, keys,
        lambda k: cv_time_varying_rank_selection(
            x, [k], n_lags, **kwargs
        ).test_error,
    )
    best = int(ranks[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(ranks, test_error, best)


def cv_space_by_time_selection_checkpointed(
    xs,
    pairs: Sequence,
    checkpoint_dir: _PathLike,
    backend: str = "npz",
    **kwargs,
) -> SpaceByTimeCVResult:
    """NM3F ``(n_temporal, n_spatial)`` selection with per-candidate
    resume (the grid is the longest selection job in the suite)."""
    pairs = tuple((int(p), int(q)) for p, q in pairs)
    ckpt = GridCheckpoint(checkpoint_dir, backend=backend)
    keys = [(f"pair_{p}x{q}", (p, q)) for p, q in pairs]
    test_error = _run_cv_candidates(
        ckpt, keys,
        lambda pq: cv_space_by_time_selection(
            xs, [pq], **kwargs
        ).test_error,
    )
    best = pairs[int(np.argmin(test_error.mean(axis=0)))]
    return SpaceByTimeCVResult(pairs, test_error, best)
