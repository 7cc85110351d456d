"""User-facing NMF model, VAF-based rank selection and synergy runs.

Capability parity with the reference's synergy layer
(reference src/muscle_synergies/analysis.py:597-914):

- :class:`NMFModel` plays the role of ``sklearn.decomposition.NMF``
  (attributes ``components_``, ``n_iter_``, ``reconstruction_err_``)
  but solves on device via the JAX MU / coordinate-descent solvers;
- :func:`find_synergies` mirrors the reference API exactly — single
  rank or a ``n_components..max_components`` sweep, VAF per rank, and a
  :class:`SynergyRunResult`;
- VAF definition: ``1 - ||x - x_r||_F^2 / ||x||_F^2`` overall and per
  muscle (reference analysis.py:597-667).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Mapping, Optional, Union

import jax.numpy as jnp
import numpy as np
from .._optional import pandas

from .hals import fit_cd
from .init import initialize_nmf
from .mu import fit_mu

__all__ = ["NMFModel", "SynergyRunResult", "find_synergies", "compute_regularization"]


def _warn_if_unconverged(n_iter: int, max_iter: int, tol: float) -> None:
    """sklearn's ConvergenceWarning when a fit exhausts ``max_iter``."""
    if n_iter == max_iter and tol > 0:
        import warnings

        try:
            from sklearn.exceptions import ConvergenceWarning as _Warn
        except ImportError:  # sklearn is optional at runtime
            _Warn = UserWarning
        warnings.warn(
            f"Maximum number of iterations {max_iter} reached. Increase "
            "it to improve convergence.",
            _Warn,
            stacklevel=3,
        )


# Sentinel distinguishing "regularization not passed" (sklearn 0.24's
# default was 'both') from an explicit regularization=None (which that
# version treated as NO regularization at all).
_UNSET = object()


def _legacy_regularization(alpha: float, regularization, l1_ratio: float):
    """sklearn <= 0.24's UNscaled penalties (the reference's pinned API).

    That era's ``_compute_regularization`` applied ``alpha`` directly —
    no ``n_samples`` / ``n_features`` factor — gated per factor by the
    ``regularization`` selector (``None`` = no penalties).
    """
    on_w = regularization in ("both", "transformation")
    on_h = regularization in ("both", "components")
    l1 = alpha * l1_ratio
    l2 = alpha * (1.0 - l1_ratio)
    return (
        l1 if on_w else 0.0,
        l2 if on_w else 0.0,
        l1 if on_h else 0.0,
        l2 if on_h else 0.0,
    )


def compute_regularization(
    alpha_w: float, alpha_h: Union[float, str], l1_ratio: float, n: int, l: int
):
    """sklearn's scaling of L1/L2 penalties by the opposite dimension."""
    if alpha_h == "same":
        alpha_h = alpha_w
    l1_reg_w = l * alpha_w * l1_ratio
    l1_reg_h = n * alpha_h * l1_ratio
    l2_reg_w = l * alpha_w * (1.0 - l1_ratio)
    l2_reg_h = n * alpha_h * (1.0 - l1_ratio)
    return l1_reg_w, l2_reg_w, l1_reg_h, l2_reg_h


class NMFModel:
    """Non-negative matrix factorization ``X ~ W @ H`` on the accelerator.

    Drop-in for the surface of ``sklearn.decomposition.NMF`` that the
    reference relies on.  ``solver`` may be ``"cd"`` (cyclic coordinate
    descent / HALS, sklearn's default) or ``"mu"`` (multiplicative
    updates).  ``beta_loss`` accepts ``"frobenius"`` (default),
    ``"kullback-leibler"``, ``"itakura-saito"`` or a float beta — any
    non-Frobenius loss requires ``solver="mu"``, as in sklearn.
    Sparsity is controlled through ``alpha_W`` / ``alpha_H`` /
    ``l1_ratio`` with sklearn's dimension-scaled penalties; the legacy
    sklearn <= 0.24 spelling ``alpha=`` + ``regularization=`` (the API
    of the version the reference pins) is accepted and mapped.
    ``inner_iter > 1`` (Frobenius MU only) repeats each factor's update
    reusing the fixed factor's cross products — the accelerated MU of
    Gillis & Glineur 2012; ``inner_iter=1`` is sklearn-exact.
    ``verbose`` is accepted for signature compatibility and ignored.
    ``svd_method="randomized"`` makes the NNDSVD-family inits
    bit-identical to sklearn's (host-side randomized SVD seeded by
    ``random_state``), so default-init runs are directly comparable.

    After :meth:`fit_transform`:

    Attributes:
        components_: ``(k, L)`` factor H.
        n_components_: the rank used.
        n_iter_: iterations run by the solver.
        reconstruction_err_: final Frobenius error ``||X - WH||_F``.
    """

    def __init__(
        self,
        n_components: Optional[int] = None,
        *,
        solver: str = "cd",
        beta_loss: Union[str, float] = "frobenius",
        init: Optional[str] = None,
        tol: float = 1e-4,
        max_iter: int = 200,
        random_state: Optional[int] = None,
        alpha_W: float = 0.0,
        alpha_H: Union[float, str] = "same",
        l1_ratio: float = 0.0,
        svd_method: str = "exact",
        alpha: Optional[float] = None,
        regularization=_UNSET,
        inner_iter: int = 1,
        verbose: int = 0,
    ):
        # Legacy sklearn <= 0.24 style (the version the reference pins,
        # reference requirements.txt:3): a single `alpha` applied per
        # `regularization`.  0.24's default was 'both'; an EXPLICIT
        # regularization=None meant no penalties at all.
        self._legacy_alpha = None
        if regularization is not _UNSET and regularization not in (
            None, "both", "components", "transformation"
        ):
            raise ValueError(
                f"invalid regularization: {regularization!r} (expected "
                "'both', 'components', 'transformation' or None)"
            )
        if alpha is not None:
            reg = "both" if regularization is _UNSET else regularization
            # sklearn <= 0.24 applied alpha UNscaled (no n_samples /
            # n_features factor — _compute_regularization of that era);
            # keep those semantics so reference-era scripts reproduce
            # their pinned-sklearn fits.  Resolved in fit_transform.
            self._legacy_alpha = (float(alpha), reg)
        self.n_components = n_components
        self.solver = solver
        self.beta_loss = beta_loss
        self.init = init
        self.tol = tol
        self.max_iter = max_iter
        self.random_state = random_state
        self.alpha_W = alpha_W
        self.alpha_H = alpha_H
        self.l1_ratio = l1_ratio
        self.svd_method = svd_method
        self.inner_iter = inner_iter
        self.verbose = verbose
        if inner_iter < 1:
            raise ValueError(f"inner_iter must be >= 1, got {inner_iter}")

    def fit_transform(
        self,
        x,
        w: Optional[np.ndarray] = None,
        h: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Factorize ``x`` and return ``W``.

        Passing both ``w`` and ``h`` uses them as the starting point
        (sklearn's ``init='custom'``).
        """
        from .beta import beta_loss_to_float, fit_mu_beta

        beta = beta_loss_to_float(self.beta_loss)
        x_host = np.asarray(x, dtype=float)
        x_arr = jnp.asarray(x_host)
        if x_arr.ndim != 2:
            raise ValueError(f"expected a 2-D matrix, got shape {x_arr.shape}")
        if x_arr.size == 0:
            raise ValueError("empty matrix passed to NMF")
        if not np.all(np.isfinite(x_host)):
            # sklearn's check_array rejects NaN/Inf before any fit
            raise ValueError("Input X contains NaN or infinity.")
        if np.any(x_host < 0):
            raise ValueError("Negative values in data passed to NMF")
        if beta <= 0 and np.any(x_host == 0):
            # sklearn's guard: zero entries make WH -> 0 poles of the
            # beta<=0 divergence
            raise ValueError(
                "When beta_loss <= 0 and X contains zeros, the solver may "
                "diverge. Please add small values to X, or use a "
                "positive beta_loss."
            )
        n, l = x_arr.shape
        k = self.n_components if self.n_components is not None else l

        if w is not None and h is not None:
            w0 = jnp.asarray(np.asarray(w, dtype=float))
            h0 = jnp.asarray(np.asarray(h, dtype=float))
        elif w is not None or h is not None:
            raise ValueError("provide both w and h for a custom init, or neither")
        elif self.init == "custom":
            # sklearn API: init='custom' requires explicit W and H
            raise ValueError(
                "init='custom' requires passing both w and h to fit_transform"
            )
        else:
            w0, h0 = initialize_nmf(
                x_arr,
                k,
                init=self.init,
                seed=self.random_state or 0,
                svd_method=self.svd_method,
            )
        w0 = w0.astype(x_arr.dtype)
        h0 = h0.astype(x_arr.dtype)

        if self._legacy_alpha is not None:
            l1_w, l2_w, l1_h, l2_h = _legacy_regularization(
                *self._legacy_alpha, self.l1_ratio
            )
        else:
            l1_w, l2_w, l1_h, l2_h = compute_regularization(
                self.alpha_W, self.alpha_H, self.l1_ratio, n, l
            )

        if beta != 2.0 and self.solver != "mu":
            # sklearn: only the MU solver handles general beta
            raise ValueError(
                f"Invalid beta_loss parameter: solver {self.solver!r} does "
                f"not handle beta_loss = {self.beta_loss!r}"
            )
        if self.inner_iter != 1 and (self.solver != "mu" or beta != 2.0):
            raise ValueError(
                "inner_iter > 1 is only available for the Frobenius MU "
                "solver"
            )
        if beta != 2.0:
            state = fit_mu_beta(
                x_arr,
                w0,
                h0,
                beta=beta,
                max_iter=self.max_iter,
                tol=float(self.tol),
                l1_reg_w=l1_w,
                l2_reg_w=l2_w,
                l1_reg_h=l1_h,
                l2_reg_h=l2_h,
            )
            w_final, h_final = state.w, state.h
        elif self.solver == "mu":
            state = fit_mu(
                x_arr,
                w0,
                h0,
                max_iter=self.max_iter,
                tol=float(self.tol),
                l1_reg_w=l1_w,
                l2_reg_w=l2_w,
                l1_reg_h=l1_h,
                l2_reg_h=l2_h,
                inner_iter=self.inner_iter,
            )
            w_final, h_final = state.w, state.h
        elif self.solver == "cd":
            state = fit_cd(
                x_arr,
                w0,
                h0,
                max_iter=self.max_iter,
                tol=float(self.tol),
                l1_reg_w=l1_w,
                l2_reg_w=l2_w,
                l1_reg_h=l1_h,
                l2_reg_h=l2_h,
            )
            w_final, h_final = state.w, state.ht.T
        else:
            raise ValueError(f"unknown solver: {self.solver!r}")

        self.n_components_ = k
        self.n_iter_ = int(state.n_iter)
        self.components_ = np.asarray(h_final)
        # sklearn: reconstruction_err_ is the square-rooted
        # beta-divergence of the *fitted* loss (Frobenius norm at beta=2).
        # One-shot report, so evaluate at HIGHEST matmul precision: the
        # fits produce float32-exact factors and a reduced-precision
        # error statement would throw that accuracy away on the device.
        import jax

        from .beta import beta_divergence

        self.reconstruction_err_ = float(
            beta_divergence(
                x_arr, w_final, h_final, beta, square_root=True,
                precision=jax.lax.Precision.HIGHEST,
            )
        )
        _warn_if_unconverged(self.n_iter_, self.max_iter, self.tol)
        return np.asarray(w_final)

    def fit(self, x, **kwargs) -> "NMFModel":
        self.fit_transform(x, **kwargs)
        return self

    def _transform_jax(self, x_arr: jnp.ndarray):
        """Pure-JAX transform: ``(W, n_iter)`` with H frozen.

        Traceable/jittable (and therefore exportable through
        :mod:`muscle_synergies_tpu.models.export`): no host-side
        conversions or warnings — :meth:`transform` wraps those around
        this core.
        """
        if not hasattr(self, "components_"):
            raise ValueError("this NMFModel instance is not fitted yet")
        h = jnp.asarray(self.components_, dtype=x_arr.dtype)
        k = h.shape[0]
        if self._legacy_alpha is not None:
            l1_w, l2_w, _, _ = _legacy_regularization(
                *self._legacy_alpha, self.l1_ratio
            )
        else:
            l1_w, l2_w, _, _ = compute_regularization(
                self.alpha_W, self.alpha_H, self.l1_ratio, *x_arr.shape
            )

        from .beta import beta_loss_to_float, fit_mu_beta

        beta = beta_loss_to_float(self.beta_loss)
        if beta != 2.0 and self.solver != "mu":
            # same guard as fit_transform: a hand-constructed or
            # unpickled model with an incompatible (solver, beta_loss)
            # pair must not silently transform with the MU solver
            raise ValueError(
                f"Invalid beta_loss parameter: solver {self.solver!r} does "
                f"not handle beta_loss = {self.beta_loss!r}"
            )
        if beta != 2.0 or self.solver == "mu":
            # sklearn seeds the multiplicative solver with the average
            # fill (zeros would be absorbing states for MU)
            avg = jnp.sqrt(jnp.maximum(jnp.mean(x_arr), 0.0) / k)
            w0 = jnp.full((x_arr.shape[0], k), avg, dtype=x_arr.dtype)
            if beta != 2.0:
                state = fit_mu_beta(
                    x_arr, w0, h, beta=beta, max_iter=self.max_iter,
                    tol=float(self.tol), l1_reg_w=l1_w, l2_reg_w=l2_w,
                    update_h=False,
                )
            else:
                state = fit_mu(
                    x_arr, w0, h, max_iter=self.max_iter,
                    tol=float(self.tol), l1_reg_w=l1_w, l2_reg_w=l2_w,
                    update_h=False,
                )
        else:
            # sklearn's CD transform starts W at zero
            w0 = jnp.zeros((x_arr.shape[0], k), dtype=x_arr.dtype)
            state = fit_cd(
                x_arr, w0, h, max_iter=self.max_iter, tol=float(self.tol),
                l1_reg_w=l1_w, l2_reg_w=l2_w, update_h=False,
            )
        return state.w, state.n_iter

    def transform(self, x) -> np.ndarray:
        """Project ``x`` onto the learned components (W with H fixed).

        Uses the *fitted* solver with frozen H, like sklearn's
        ``transform`` (``_fit_transform(X, H=components_,
        update_H=False)``), including the same averaged W fill and the
        W-side regularization.
        """
        w, n_iter = self._transform_jax(
            jnp.asarray(np.asarray(x, dtype=float))
        )
        _warn_if_unconverged(int(n_iter), self.max_iter, self.tol)
        return np.asarray(w)

    def inverse_transform(self, w) -> np.ndarray:
        return np.asarray(w) @ self.components_

    def save(self, path):
        """Persist the fitted model as a pickle-free ``.npz``
        (:func:`muscle_synergies_tpu.models.persist.save_model`)."""
        from .persist import save_model

        return save_model(self, path)

    @classmethod
    def load(cls, path) -> "NMFModel":
        """Load a model saved by :meth:`save` (``allow_pickle=False``;
        safe on untrusted files)."""
        from .persist import load_model

        model = load_model(path)
        if not isinstance(model, cls):
            raise TypeError(
                f"{path} holds a {type(model).__name__}, not {cls.__name__}"
            )
        return model


@dataclass
class SynergyRunResult:
    """Result of one or several synergy factorization runs.

    Attributes:
        vaf_values: one row per rank; first column ``"All signals"``
            then per-muscle VAF.  The index is the rank when a sweep was
            run.
        components: ``(k, num_muscles)`` DataFrame (single run) or a
            dict mapping rank to DataFrame.
        model: the fitted :class:`NMFModel` (or dict of them).
    """

    vaf_values: pandas.DataFrame
    components: Union[pandas.DataFrame, Mapping[int, pandas.DataFrame]]
    model: Union[NMFModel, Mapping[int, NMFModel]]

    def save(self, path):
        """Persist the whole run (VAF table, components, models) as a
        pickle-free ``.npz``
        (:func:`muscle_synergies_tpu.models.persist.save_synergy_run`)."""
        from .persist import save_synergy_run

        return save_synergy_run(self, path)

    @classmethod
    def load(cls, path) -> "SynergyRunResult":
        """Load a run saved by :meth:`save` (``allow_pickle=False``)."""
        from .persist import load_synergy_run

        return load_synergy_run(path)


def find_synergies(
    processed_emg_df: pandas.DataFrame,
    n_components: int,
    max_components: Optional[int] = None,
    *,
    max_iter: int = 100_000,
    tol: float = 1e-6,
    sweep: str = "loop",
    **nmf_kwargs,
) -> SynergyRunResult:
    """Extract spatial muscle synergies by non-negative factorization.

    Mirrors the reference API (analysis.py:713-914): the processed EMG
    (``(num_measurements, num_muscles)``, non-negative) is factorized
    at rank ``n_components`` — or at every rank from ``n_components``
    to ``max_components`` — and each run's VAF is reported.

    ``sweep`` selects how a rank *range* is executed: ``"loop"`` fits
    one rank at a time (the reference's sequential Python loop,
    analysis.py:909-913), ``"batched"`` stacks every rank into one
    zero-rank-padded batch and solves them all in a single device
    dispatch (padded components stay exactly zero under both solvers,
    so each entry equals its independent fit).  In float64 the two
    modes stop at identical iterates; in float32 the vmapped solve can
    fuse differently and shift a convergence checkpoint by a step or
    two (components agree to round-off).  ``"batched"`` supports the
    full sparsity surface (``alpha_W``/``alpha_H``/``l1_ratio`` and the
    legacy ``alpha=``/``regularization=``) plus ``inner_iter``; custom
    inits still require ``sweep="loop"``.

    Raises:
        ValueError: when the EMG frame is empty, or the rank range does
            not satisfy ``1 <= n_components <= max_components <=
            num_muscles``.
    """
    from ..analysis import vaf as _vaf

    if processed_emg_df.empty:
        raise ValueError("empty EMG DataFrame")
    num_features = len(processed_emg_df.columns)
    if n_components < 1 or n_components > num_features:
        raise ValueError("invalid number of components")
    if max_components is not None:
        if max_components < n_components or max_components > num_features:
            raise ValueError("invalid number of components")
    if sweep not in ("loop", "batched"):
        raise ValueError(f"unknown sweep mode: {sweep!r}")
    if sweep == "batched" and max_components is not None:
        return _sweep_batched(
            processed_emg_df,
            range(n_components, max_components + 1),
            max_iter=max_iter,
            tol=tol,
            **nmf_kwargs,
        )

    def single_run(k: int) -> SynergyRunResult:
        model = NMFModel(n_components=k, max_iter=max_iter, tol=tol, **nmf_kwargs)
        transformed = model.fit_transform(processed_emg_df)
        vaf_values = _vaf(
            processed_emg_df,
            components=model.components_,
            transformed_signal=transformed,
        )
        comps = pandas.DataFrame(
            model.components_, columns=processed_emg_df.columns
        )
        return SynergyRunResult(vaf_values, comps, model)

    if max_components is None:
        return single_run(n_components)

    runs = OrderedDict(
        (k, single_run(k)) for k in range(n_components, max_components + 1)
    )
    vaf_values = pandas.concat([r.vaf_values for r in runs.values()])
    vaf_values.set_index(np.array(tuple(runs.keys())), inplace=True)
    return SynergyRunResult(
        vaf_values,
        {k: r.components for k, r in runs.items()},
        {k: r.model for k, r in runs.items()},
    )


def _sweep_batched(
    processed_emg_df: pandas.DataFrame,
    ranks,
    *,
    max_iter: int,
    tol: float,
    solver: str = "cd",
    beta_loss: Union[str, float] = "frobenius",
    init: Optional[str] = None,
    random_state: Optional[int] = None,
    svd_method: str = "exact",
    alpha_W: float = 0.0,
    alpha_H: Union[float, str] = "same",
    l1_ratio: float = 0.0,
    alpha: Optional[float] = None,
    regularization=_UNSET,
    inner_iter: int = 1,
    verbose: int = 0,
    **unsupported,
) -> SynergyRunResult:
    """Run a rank sweep as one zero-rank-padded batched device solve.

    The batched device execution of the reference's sequential rank loop
    (reference analysis.py:909-913): every rank's problem becomes one
    entry of a ``(R, N, L)`` batch with factors zero-padded to
    ``max(ranks)``; multiplicative updates and HALS both keep padded
    components exactly zero (their numerators are identically zero —
    the L1/L2 penalties only touch denominators, and CD's projected
    Newton step clips the bare L1 pull at zero), so entry ``i`` equals
    the independent rank-``ranks[i]`` fit while the whole sweep costs a
    single dispatch with per-entry stopping.  Supports the same
    regularization surface as the loop path: sklearn's dimension-scaled
    ``alpha_W``/``alpha_H``/``l1_ratio`` and the legacy <= 0.24
    ``alpha=``/``regularization=`` spelling, plus the accelerated-MU
    ``inner_iter``.
    """
    if unsupported:
        raise ValueError(
            "sweep='batched' does not support "
            f"{sorted(unsupported)}; use the default sweep='loop'"
        )
    if regularization is not _UNSET and regularization not in (
        None, "both", "components", "transformation"
    ):
        raise ValueError(
            f"invalid regularization: {regularization!r} (expected "
            "'both', 'components', 'transformation' or None)"
        )
    from ..analysis import vaf as _vaf
    from .batch import rank_sweep_batch
    from .beta import beta_loss_to_float

    beta = beta_loss_to_float(beta_loss)
    arr = processed_emg_df.to_numpy(dtype=float)
    if not np.all(np.isfinite(arr)):
        raise ValueError("Input X contains NaN or infinity.")
    if np.any(arr < 0):  # host-side: no device round trip for the test
        raise ValueError("Negative values in data passed to NMF")
    if beta <= 0 and np.any(arr == 0):
        raise ValueError(
            "When beta_loss <= 0 and X contains zeros, the solver may "
            "diverge. Please add small values to X, or use a positive "
            "beta_loss."
        )
    x = jnp.asarray(arr)
    ranks = list(ranks)
    if alpha is not None:
        reg = "both" if regularization is _UNSET else regularization
        l1_w, l2_w, l1_h, l2_h = _legacy_regularization(alpha, reg, l1_ratio)
    else:
        l1_w, l2_w, l1_h, l2_h = compute_regularization(
            alpha_W, alpha_H, l1_ratio, *arr.shape
        )
    states, _ = rank_sweep_batch(
        x, ranks, init=init, solver=solver, max_iter=max_iter,
        tol=float(tol), seed=random_state or 0, svd_method=svd_method,
        beta_loss=beta_loss, inner_iter=inner_iter,
        l1_reg_w=l1_w, l2_reg_w=l2_w, l1_reg_h=l1_h, l2_reg_h=l2_h,
    )
    if solver == "mu":
        w_all, h_all = states.w, states.h
    else:
        w_all, h_all = states.w, jnp.swapaxes(states.ht, -1, -2)

    n_iters = np.asarray(states.n_iter)
    vaf_rows, comps, models = [], {}, {}
    for i, k in enumerate(ranks):
        w = np.asarray(w_all[i][:, :k])
        h = np.asarray(h_all[i][:k, :])
        vaf_rows.append(
            _vaf(processed_emg_df, components=h, transformed_signal=w)
        )
        comps[k] = pandas.DataFrame(h, columns=processed_emg_df.columns)
        model = NMFModel(
            n_components=k, solver=solver, beta_loss=beta_loss, init=init,
            tol=tol, max_iter=max_iter, random_state=random_state,
            svd_method=svd_method, alpha_W=alpha_W, alpha_H=alpha_H,
            l1_ratio=l1_ratio, alpha=alpha, regularization=regularization,
            inner_iter=inner_iter,
        )
        model.n_components_ = k
        model.n_iter_ = int(n_iters[i])
        model.components_ = h
        # One-shot report at HIGHEST precision, same as NMFModel above.
        import jax

        from .beta import beta_divergence

        model.reconstruction_err_ = float(
            beta_divergence(
                x, jnp.asarray(w), jnp.asarray(h), beta, square_root=True,
                precision=jax.lax.Precision.HIGHEST,
            )
        )
        _warn_if_unconverged(model.n_iter_, max_iter, tol)
        models[k] = model

    vaf_values = pandas.concat(vaf_rows)
    vaf_values.set_index(np.array(ranks), inplace=True)
    return SynergyRunResult(vaf_values, comps, models)
