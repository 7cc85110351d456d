"""Tracing, timing and solver telemetry.

The reference has no profiling or observability at all (SURVEY §5).
This module provides:

- :class:`Timer` / :func:`annotate`: wall-clock scopes that also emit
  ``jax.profiler`` trace annotations so they show up on device traces;
- :func:`solver_report`: structured telemetry from solver states
  (iterations, final loss, convergence flags) — the batched analog of
  sklearn's ``n_iter_`` / ``reconstruction_err_``;
- :func:`debug_nans`: a context manager flipping JAX's NaN checker on
  for a scope (the functional equivalent of a sanitizer pass).
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np

__all__ = ["Timer", "annotate", "solver_report", "debug_nans"]


class Timer:
    """Wall-clock scope timer usable as a context manager.

    Example:
        >>> with Timer("fit") as t:  # doctest: +SKIP
        ...     run()
        >>> t.elapsed  # doctest: +SKIP
    """

    def __init__(self, name: str = "", verbose: bool = False):
        self.name = name
        self.verbose = verbose
        self.elapsed: Optional[float] = None

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if self.verbose:  # pragma: no cover - logging path
            print(f"[{self.name}] {self.elapsed * 1e3:.2f} ms")
        return False


@contextlib.contextmanager
def annotate(name: str):
    """Named scope that appears in ``jax.profiler`` device traces."""
    import jax.profiler

    with jax.profiler.TraceAnnotation(name):
        yield


def solver_report(state, x=None) -> Dict:
    """Structured telemetry from a (possibly batched) solver state.

    Works with :class:`~muscle_synergies_tpu.models.mu.MUState` and
    :class:`~muscle_synergies_tpu.models.hals.CDState` (including
    vmapped/sharded ones).

    Returns:
        dict with ``n_iter`` (per trial), ``converged`` fraction, and
        when ``x`` is given the exact final Frobenius error per trial.
    """
    report: Dict = {
        "n_iter": np.asarray(state.n_iter),
        "converged": np.asarray(state.converged),
        "converged_fraction": float(np.mean(np.asarray(state.converged))),
    }
    if hasattr(state, "previous_error"):
        report["error_at_last_check"] = np.asarray(state.previous_error)
    if x is not None:
        import jax.numpy as jnp

        w = state.w
        h = state.h if hasattr(state, "h") else jnp.swapaxes(state.ht, -1, -2)
        diff = jnp.asarray(x) - w @ h
        axes = tuple(range(diff.ndim))[-2:]
        report["final_error"] = np.asarray(
            jnp.sqrt(jnp.sum(diff * diff, axis=axes))
        )
    return report


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Scope with JAX's NaN debugging toggled (restores prior value)."""
    import jax

    previous = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", previous)
