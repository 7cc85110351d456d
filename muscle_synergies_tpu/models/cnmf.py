"""Convolutive NMF: time-varying muscle synergies, fused on device.

The reference extracts *time-invariant* synergies only (a single
``sklearn.decomposition.NMF`` per trial — reference analysis.py:848-864).
The muscle-synergy literature's second canonical model is the
*time-varying* synergy of d'Avella, Saltiel & Bizzi (2003): each synergy
is a short spatiotemporal pattern ``S_k ∈ R^{D x L}`` (D lags x L
muscles) recruited by a nonnegative activation train ``c_k(t)``, so

    X[t, l] ≈ Σ_k Σ_d C[t - d, k] · S[k, d, l]

— a 1-D convolution over time.  This module implements the
multiplicative updates for that model (Smaragdis 2004's convolutive
NMF, transposed to this package's ``(time, muscles)`` orientation)
as a fused JAX loop:

- the reconstruction and both update numerators/denominators are
  lag-stacked einsums — ``(D·T, K) @ (K, L)``-shaped contractions that
  XLA tiles as batched matrix products (no scalar time loops);
- the whole fit is one ``lax.while_loop`` with sklearn-style stopping
  (relative Frobenius improvement every ``check_every`` iterations,
  ``EPSILON``-guarded denominators), so a fit is a single device
  computation, and ``vmap`` batches it over trials exactly like
  :func:`muscle_synergies_tpu.models.batch.fit_mu_batch`;
- ``C`` is updated with the ratio-of-sums rule (one update using all
  lags), the standard practical variant.

Scale indeterminacy is fixed by :func:`normalize_synergies` (unit
Frobenius norm per synergy, activations rescaled inversely).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.platform import resolve_impl
from .mu import EPSILON, full_precision

__all__ = [
    "CNMFModel",
    "CNMFState",
    "TimeVaryingSynergyResult",
    "cnmf_reconstruct",
    "cnmf_transform",
    "cnmf_update",
    "cnmf_iterations_batch",
    "find_time_varying_synergies",
    "fit_cnmf",
    "fit_cnmf_batch",
    "init_cnmf",
    "normalize_synergies",
    "tvaf",
]


def _shift_down(c: jnp.ndarray, d: int) -> jnp.ndarray:
    """``out[t] = c[t - d]`` with zeros for ``t < d`` (causal shift)."""
    if d == 0:
        return c
    t = c.shape[0]
    return jnp.concatenate([jnp.zeros((d,) + c.shape[1:], c.dtype), c[: t - d]])


def _shift_up(c: jnp.ndarray, d: int) -> jnp.ndarray:
    """``out[t] = c[t + d]`` with zeros for ``t >= T - d``."""
    if d == 0:
        return c
    t = c.shape[0]
    return jnp.concatenate([c[d:], jnp.zeros((d,) + c.shape[1:], c.dtype)])


def _lag_stack(c: jnp.ndarray, n_lags: int) -> jnp.ndarray:
    """``(T, K) -> (D, T, K)`` with ``out[d, t] = c[t - d]``.

    ``n_lags`` is static under jit, so the stack is an unrolled set of
    pad-and-slice ops XLA fuses into one gather.
    """
    return jnp.stack([_shift_down(c, d) for d in range(n_lags)])


def cnmf_reconstruct(
    c: jnp.ndarray, s: jnp.ndarray, precision=None
) -> jnp.ndarray:
    """Reconstruction ``X̂[t, l] = Σ_k Σ_d C[t-d, k] S[k, d, l]``.

    Args:
        c: ``(T, K)`` nonnegative activation trains.
        s: ``(K, D, L)`` spatiotemporal synergies.
        precision: matmul precision for the contraction; ``None``
            follows the caller's default (the fits run their products
            at full float32, see
            :func:`~muscle_synergies_tpu.models.mu.full_precision`;
            ``"default"`` asks for the platform's fast default, which
            may round float32 products through TF32).
    """
    cs = _lag_stack(c, s.shape[1])  # (D, T, K)
    return jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)


@full_precision
def cnmf_update(
    x: jnp.ndarray,
    c: jnp.ndarray,
    s: jnp.ndarray,
    update_c: bool = True,
    update_s: bool = True,
    precision=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One multiplicative update of S then C.

    S update (each lag slice independently, exact MU):
        ``S[k, d] ⊙= (shift_d(C)ᵀ X) / (shift_d(C)ᵀ X̂)``
    C update (ratio of sums over lags):
        ``C ⊙= (Σ_d shift_{-d}(X S_dᵀ)) / (Σ_d shift_{-d}(X̂ S_dᵀ))``

    ``update_c=False`` freezes the activations — estimating the
    synergy library for *known* recruitment trains.  ``update_s=False``
    freezes the synergies — the ``transform`` analog (sklearn
    ``NMF.transform`` semantics transposed to this model): project new
    data onto a fixed library, as :func:`cnmf_transform` does.
    """
    n_lags = s.shape[1]

    if update_s:
        cs = _lag_stack(c, n_lags)  # (D, T, K)
        xhat = jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
        num_s = jnp.einsum("dtk,tl->kdl", cs, x, precision=precision)
        den_s = jnp.einsum("dtk,tl->kdl", cs, xhat, precision=precision)
        s = s * (num_s / jnp.where(den_s == 0, EPSILON, den_s))

    if not update_c:
        return c, s

    cs = _lag_stack(c, n_lags)
    xhat = jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
    # G[d, t, k] = Σ_l X[t, l] S[k, d, l]; numerator is Σ_d G[d, t+d, k]
    g_num = jnp.einsum("tl,kdl->dtk", x, s, precision=precision)
    g_den = jnp.einsum("tl,kdl->dtk", xhat, s, precision=precision)
    num_c = sum(_shift_up(g_num[d], d) for d in range(n_lags))
    den_c = sum(_shift_up(g_den[d], d) for d in range(n_lags))
    c = c * (num_c / jnp.where(den_c == 0, EPSILON, den_c))
    return c, s


class CNMFState(NamedTuple):
    c: jnp.ndarray  # (T, K) activations
    s: jnp.ndarray  # (K, D, L) spatiotemporal synergies
    n_iter: jnp.ndarray  # int32
    previous_error: jnp.ndarray
    converged: jnp.ndarray  # bool


@full_precision
def _frobenius_error(x, c, s, precision=None):
    diff = x - cnmf_reconstruct(c, s, precision=precision)
    return jnp.sqrt(jnp.sum(diff * diff))


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter", "tol", "check_every", "update_c", "update_s",
        "precision",
    ),
)
def fit_cnmf(
    x: jnp.ndarray,
    c0: jnp.ndarray,
    s0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    update_c: bool = True,
    update_s: bool = True,
    precision=None,
) -> CNMFState:
    """Run convolutive NMF to convergence in one device computation.

    Stopping matches the package's NMF solvers (sklearn's rule): every
    ``check_every`` iterations evaluate the Frobenius error and stop
    when ``(previous - current) / initial < tol``.

    Args:
        x: ``(T, L)`` nonnegative data (time x muscles).
        c0: ``(T, K)`` initial activations.
        s0: ``(K, D, L)`` initial synergies.
        update_c / update_s: freeze one factor (see
            :func:`cnmf_update`; freezing both is rejected).
        precision: matmul precision for the update contractions (see
            :func:`cnmf_reconstruct`).  The stopping criterion's error
            checks default to ``jax.lax.Precision.HIGHEST`` regardless
            (a reduced-precision Frobenius statistic can flip
            near-threshold stopping decisions) — passing an explicit
            ``precision`` applies it to the checks too.
    """
    if not (update_c or update_s):
        raise ValueError("update_c and update_s cannot both be False")
    check_precision = (
        precision if precision is not None else jax.lax.Precision.HIGHEST
    )
    error_init = _frobenius_error(x, c0, s0, precision=check_precision)

    def cond(state: CNMFState):
        return (state.n_iter < max_iter) & ~state.converged

    def body(state: CNMFState):
        c, s = state.c, state.s
        for _ in range(check_every):
            c, s = cnmf_update(x, c, s, update_c=update_c,
                               update_s=update_s, precision=precision)
        error = _frobenius_error(x, c, s, precision=check_precision)
        improvement = (state.previous_error - error) / jnp.maximum(
            error_init, EPSILON
        )
        return CNMFState(
            c,
            s,
            state.n_iter + check_every,
            error,
            improvement < tol,
        )

    init = CNMFState(
        c0.astype(x.dtype),
        s0.astype(x.dtype),
        jnp.asarray(0, jnp.int32),
        error_init,
        jnp.asarray(False),
    )
    return jax.lax.while_loop(cond, body, init)


def fit_cnmf_batch(
    xs: jnp.ndarray,
    c0: jnp.ndarray,
    s0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    update_c: bool = True,
    update_s: bool = True,
    precision=None,
) -> CNMFState:
    """Convergence-mode convolutive NMF over a ``(B, T, L)`` stack.

    Vmaps :func:`fit_cnmf`; per-trial stopping is exact (each trial's
    while-loop condition is evaluated independently under vmap, so
    converged trials freeze while the rest keep iterating).
    ``precision`` threads through every contraction.
    """
    return _fit_cnmf_batch_xla(
        xs, c0, s0, max_iter=max_iter, tol=tol,
        check_every=check_every, update_c=update_c, update_s=update_s,
        precision=precision,
    )


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter", "tol", "check_every", "update_c", "update_s",
        "precision",
    ),
)
def _fit_cnmf_batch_xla(
    xs, c0, s0, max_iter, tol, check_every, update_c, update_s=True,
    precision=None,
) -> CNMFState:
    return jax.vmap(
        lambda x, c, s: fit_cnmf(
            x,
            c,
            s,
            max_iter=max_iter,
            tol=tol,
            check_every=check_every,
            update_c=update_c,
            update_s=update_s,
            precision=precision,
        )
    )(xs, c0, s0)


def _init_c_on_device(x: jnp.ndarray, k: int, n_lags: int,
                      seed: int) -> jnp.ndarray:
    """On-device scaled-random activation init (the ``C`` half of
    :func:`init_cnmf`'s scaling rule, via the JAX PRNG).

    Fully traceable: no host RNG and no blocking device->host readback
    of the data mean, so :func:`cnmf_transform` stays jittable and
    exportable (:mod:`muscle_synergies_tpu.models.export`).  Batched
    inputs draw per-trial (``fold_in(seed, b)``) like ``init_cnmf``'s
    ``seed + b`` convention.
    """
    import jax

    key = jax.random.PRNGKey(seed)
    denom = float(k * n_lags)
    if x.ndim == 2:
        scale = jnp.sqrt(jnp.mean(x) / denom) if x.size else 1.0
        u = jax.random.uniform(key, (x.shape[0], k), dtype=x.dtype)
        return u * (2.0 * scale)
    b, t, _ = x.shape
    scales = jnp.sqrt(jnp.mean(x, axis=(1, 2)) / denom)  # (B,)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(b))
    draws = jax.vmap(
        lambda kk: jax.random.uniform(kk, (t, k), dtype=x.dtype)
    )(keys)
    return draws * (2.0 * scales)[:, None, None]


def cnmf_transform(
    x: jnp.ndarray,
    s: jnp.ndarray,
    c0: Optional[jnp.ndarray] = None,
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    precision=None,
) -> CNMFState:
    """Project data onto a FIXED synergy library: solve C, freeze S.

    The convolutive analog of ``NMFModel.transform`` (sklearn
    ``NMF.transform`` runs the same updates with the components frozen;
    the reference reaches it through sklearn, reference
    analysis.py:848-864): given spatiotemporal synergies from a prior
    fit — e.g. ``find_time_varying_synergies(...).synergies`` stacked
    to ``(K, D, L)`` — recover the recruitment trains of *new* trials.

    Args:
        x: ``(T, L)`` or batched ``(B, T, L)`` nonnegative data.
        s: ``(K, D, L)`` fixed synergies (or ``(B, K, D, L)`` matching
            a batched ``x``).
        c0: optional initial activations; defaults to an on-device
            scaled random init (:func:`init_cnmf`'s scaling rule via
            the JAX PRNG, keeping the whole transform traceable).
        max_iter / tol: sklearn-style stopping on the Frobenius error.

    Returns:
        :class:`CNMFState` whose ``s`` equals the input bit-for-bit.
    """
    x = jnp.asarray(x)
    s = jnp.asarray(s)
    batched = x.ndim == 3
    if c0 is None:
        k = s.shape[-3]
        n_lags = s.shape[-2]
        c0 = _init_c_on_device(x, k, n_lags, seed)
    else:
        c0 = jnp.asarray(c0)
    if batched:
        if s.ndim == 3:
            s = jnp.broadcast_to(s, x.shape[:1] + s.shape)
        return _fit_cnmf_batch_xla(
            x, c0, s, max_iter=max_iter, tol=tol, check_every=10,
            update_c=True, update_s=False, precision=precision,
        )
    return fit_cnmf(
        x, c0, s, max_iter=max_iter, tol=tol, update_s=False,
        precision=precision,
    )


def _cnmf_iterations_xla(xs, c0, s0, n_iters, update_c=True,
                         precision=None):
    def one(x, c, s):
        def body(_, cs_):
            return cnmf_update(x, cs_[0], cs_[1], update_c=update_c,
                               precision=precision)

        return jax.lax.fori_loop(0, n_iters, body, (c, s))

    return jax.vmap(one)(xs, c0, s0)


def cnmf_iterations_batch(
    xs: jnp.ndarray,
    c0: jnp.ndarray,
    s0: jnp.ndarray,
    n_iters,
    update_c: bool = True,
    precision=None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """``n_iters`` convolutive updates on a ``(B, T, L)`` batch.

    The fixed-iteration benchmarking/chunking twin of
    :func:`fit_cnmf_batch` (no convergence checks); ``n_iters`` may be
    a traced scalar.

    Args:
        precision: matmul precision for the lag-stacked einsums.
    """
    return _cnmf_iterations_xla(
        xs, c0, s0, n_iters, update_c=update_c, precision=precision
    )


def init_cnmf(
    x: np.ndarray,
    n_synergies: int,
    n_lags: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Scaled-random nonnegative init (sklearn's ``init='random'`` scale).

    Factors are drawn uniform and scaled so the reconstruction's
    expected magnitude matches the data:
    ``sqrt(mean(X) / (K · D · E[c]·E[s]))`` per factor entry.

    Batched inputs ``(B, T, L)`` return batched factors.
    """
    x = np.asarray(x)
    if x.ndim == 3:
        pairs = [
            init_cnmf(x[b], n_synergies, n_lags, seed=seed + b)
            for b in range(x.shape[0])
        ]
        return (
            np.stack([p[0] for p in pairs]),
            np.stack([p[1] for p in pairs]),
        )
    t, n_m = x.shape
    rng = np.random.default_rng(seed)
    scale = np.sqrt(x.mean() / (n_synergies * n_lags)) if x.size else 1.0
    c = rng.uniform(0, 2 * scale, size=(t, n_synergies))
    s = rng.uniform(0, 2 * scale, size=(n_synergies, n_lags, n_m))
    return c.astype(x.dtype, copy=False), s.astype(x.dtype, copy=False)


def normalize_synergies(
    c: jnp.ndarray, s: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unit-Frobenius-norm synergies; activations rescaled inversely.

    Leaves the reconstruction bit-unchanged up to one multiply per
    factor; zero synergies (norm 0) are left untouched.
    Accepts single ``(T,K)/(K,D,L)`` or batched ``(B,...)`` factors.
    """
    batched = s.ndim == 4
    axes = (2, 3) if batched else (1, 2)
    norms = jnp.sqrt(jnp.sum(s * s, axis=axes, keepdims=True))
    safe = jnp.where(norms == 0, 1.0, norms)
    s_out = s / safe
    c_scale = jnp.squeeze(safe, axis=axes[-1])  # (…, K, 1) -> align to C
    c_out = c * jnp.swapaxes(c_scale, -1, -2)
    return c_out, s_out


class TimeVaryingSynergyResult(NamedTuple):
    """Best-restart result of :func:`find_time_varying_synergies`.

    Attributes:
        synergies: ``{k: (n_lags, n_muscles) DataFrame}`` — one
            spatiotemporal pattern per synergy, unit Frobenius norm,
            columns named after the muscles.
        activations: ``(T, n_synergies)`` DataFrame of recruitment
            trains on the input's time index.
        vaf: overall VAF of the reconstruction (scalar float).
        vaf_per_muscle: Series of per-muscle VAF, indexed by muscle.
        n_iter: iterations used by the winning restart.
        restart_errors: final Frobenius error of every restart (the
            winner is the argmin).
    """

    synergies: dict
    activations: "object"
    vaf: float
    vaf_per_muscle: "object"
    n_iter: int
    restart_errors: np.ndarray


def _time_varying(
    x_host: np.ndarray,
    n_synergies: int,
    n_lags: int,
    max_iter: int,
    tol: float,
    n_inits: int,
    seed: int,
    impl: str,
    precision,
) -> TimeVaryingSynergyResult:
    """Array core of :func:`find_time_varying_synergies`: the same
    result with numpy arrays in place of the DataFrames (``synergies``
    is ``{k: (D, L) array}``, ``activations`` ``(T, K)`` and
    ``vaf_per_muscle`` ``(L,)``)."""
    if x_host.ndim != 2:
        raise ValueError(f"expected a 2-D matrix, got shape {x_host.shape}")
    if x_host.size == 0:
        raise ValueError("empty matrix passed to convolutive NMF")
    if not np.all(np.isfinite(x_host)):
        raise ValueError("Input X contains NaN or infinity.")
    if np.any(x_host < 0):
        raise ValueError("Negative values in data passed to NMF")
    t, n_m = x_host.shape
    if not 1 <= n_synergies:
        raise ValueError(f"n_synergies must be >= 1, got {n_synergies}")
    if not 1 <= n_lags <= t:
        raise ValueError(
            f"n_lags must be in [1, n_samples={t}], got {n_lags}"
        )
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")

    resolve_impl(impl, "cnmf")

    xs = np.broadcast_to(x_host, (n_inits,) + x_host.shape)
    c0, s0 = init_cnmf(xs, n_synergies, n_lags, seed=seed)
    state = fit_cnmf_batch(
        jnp.asarray(xs), jnp.asarray(c0), jnp.asarray(s0),
        max_iter=max_iter, tol=tol, precision=precision,
    )
    errors = np.asarray(state.previous_error)
    best = int(np.argmin(errors))
    c, s = normalize_synergies(state.c[best], state.s[best])
    c_np, s_np = np.asarray(c), np.asarray(s)

    recon = np.asarray(cnmf_reconstruct(c, s, precision=precision))
    err2 = ((x_host - recon) ** 2).sum(axis=0)
    tot2 = (x_host**2).sum(axis=0)
    per_muscle = 1.0 - err2 / np.where(tot2 == 0, 1.0, tot2)

    overall = 1.0 - float(((x_host - recon) ** 2).sum()) / max(
        float((x_host**2).sum()), float(EPSILON)
    )
    return TimeVaryingSynergyResult(
        synergies={k: s_np[k] for k in range(n_synergies)},
        activations=c_np,
        vaf=overall,
        vaf_per_muscle=per_muscle,
        n_iter=int(state.n_iter[best]),
        restart_errors=errors,
    )


def find_time_varying_synergies(
    signal_df,
    n_synergies: int,
    n_lags: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    impl: str = "auto",
    precision=None,
) -> TimeVaryingSynergyResult:
    """Extract d'Avella-style time-varying synergies from an EMG frame.

    The beyond-reference companion to ``find_synergies`` (reference
    analysis.py:713 extracts time-invariant synergies only): each
    synergy is a ``(n_lags, n_muscles)`` spatiotemporal pattern and the
    model is a sum of convolutions.  Multi-restart is free parallelism
    on the device: the ``n_inits`` random restarts are stacked on a batch axis
    and solved in ONE device dispatch by :func:`fit_cnmf_batch`; the
    best restart (lowest final Frobenius error) is returned with
    unit-norm synergies.

    Args:
        signal_df: nonnegative ``(T, n_muscles)`` DataFrame (e.g. a
            rectified envelope), or a plain 2-D array.
        n_synergies: number of time-varying synergies ``K``.
        n_lags: temporal extent ``D`` of each synergy, in samples.
        max_iter / tol: sklearn-style stopping (see :func:`fit_cnmf`).
        n_inits: random restarts (batched into one computation).
        seed: base seed; restart ``r`` uses ``seed + r``.
        impl: ``"auto"`` (default) or ``"xla"``: the convolutive
            model has no hand-written kernel, so both run the batched
            XLA fit (see
            :func:`muscle_synergies_tpu.utils.platform.resolve_impl`;
            ``"pallas"`` raises).
        precision: matmul precision for the contractions (e.g.
            ``"highest"`` for full float32 products).
    """
    import pandas

    res = _time_varying(
        np.asarray(signal_df, dtype=float), n_synergies, n_lags,
        max_iter, tol, n_inits, seed, impl, precision,
    )
    t, n_m = res.activations.shape[0], res.vaf_per_muscle.shape[0]
    if isinstance(signal_df, pandas.DataFrame):
        columns, index = signal_df.columns, signal_df.index
    else:
        columns = pandas.RangeIndex(n_m)
        index = pandas.RangeIndex(t)
    return res._replace(
        synergies={
            k: pandas.DataFrame(v, columns=columns)
            for k, v in res.synergies.items()
        },
        activations=pandas.DataFrame(
            res.activations, index=index,
            columns=[f"synergy {k}" for k in range(n_synergies)],
        ),
        vaf_per_muscle=pandas.Series(res.vaf_per_muscle, index=columns),
    )


class CNMFModel:
    """sklearn-style estimator for the time-varying synergy model.

    The convolutive companion to
    :class:`muscle_synergies_tpu.models.select.NMFModel` (the reference
    has no convolutive surface at all — beyond-reference capability):
    ``fit`` / ``fit_transform`` solve both factors with batched
    multi-restart via :func:`find_time_varying_synergies`;
    ``transform`` projects new trials onto the fitted library with the
    synergies frozen (:func:`cnmf_transform`).

    Attributes after fitting:
        synergies_: ``(K, D, L)`` unit-Frobenius-norm library.
        n_components_ / n_lags_: model order actually used.
        n_iter_: iterations of the winning restart.
        reconstruction_err_: its final Frobenius error.
        restart_errors_: ``(n_inits,)`` final errors of all restarts.
    """

    def __init__(
        self,
        n_components: int,
        n_lags: int,
        *,
        tol: float = 1e-5,
        max_iter: int = 500,
        n_inits: int = 4,
        random_state: int = 0,
        impl: str = "auto",
        precision=None,
    ):
        self.n_components = n_components
        self.n_lags = n_lags
        self.tol = tol
        self.max_iter = max_iter
        self.n_inits = n_inits
        self.random_state = random_state
        self.impl = impl
        self.precision = precision

    def _set_fitted(self, res: "TimeVaryingSynergyResult") -> None:
        self.synergies_ = np.stack(
            [np.asarray(res.synergies[k]) for k in range(self.n_components)]
        )
        self.n_components_ = self.n_components
        self.n_lags_ = self.n_lags
        self.n_iter_ = res.n_iter
        self.restart_errors_ = res.restart_errors
        self.reconstruction_err_ = float(res.restart_errors.min())

    def fit_transform(self, X) -> np.ndarray:
        """Fit the library and return the ``(T, K)`` activations."""
        res = _time_varying(
            np.asarray(X, dtype=float), self.n_components, self.n_lags,
            self.max_iter, self.tol, self.n_inits, self.random_state,
            self.impl, self.precision,
        )
        self._set_fitted(res)
        return res.activations

    def fit(self, X) -> "CNMFModel":
        self.fit_transform(X)
        return self

    @classmethod
    def from_result(
        cls, res: "TimeVaryingSynergyResult", n_lags: int, **kwargs
    ) -> "CNMFModel":
        """Wrap a :func:`find_time_varying_synergies` result as a
        fitted estimator (e.g. to ``save`` it or ``transform`` new
        trials without refitting).  ``kwargs`` are the constructor
        hyperparameters the result was produced with."""
        model = cls(len(res.synergies), n_lags, **kwargs)
        model._set_fitted(res)
        return model

    def _check_fitted(self):
        if not hasattr(self, "synergies_"):
            raise ValueError(
                "this CNMFModel instance is not fitted yet; call fit or "
                "fit_transform first"
            )

    def _transform_jax(self, x: jnp.ndarray) -> jnp.ndarray:
        """Pure-JAX transform: activations with the library frozen.

        Traceable/jittable (and therefore exportable through
        :mod:`muscle_synergies_tpu.models.export`)."""
        self._check_fitted()
        state = cnmf_transform(
            x, jnp.asarray(self.synergies_, dtype=x.dtype),
            max_iter=self.max_iter, tol=self.tol, seed=self.random_state,
            precision=self.precision,
        )
        return state.c

    def transform(self, X) -> np.ndarray:
        """Activations of new data against the FITTED library."""
        self._check_fitted()
        x = np.asarray(X, dtype=float)
        return np.asarray(self._transform_jax(jnp.asarray(x)))

    def inverse_transform(self, C) -> np.ndarray:
        """Reconstruction ``X̂`` from activations and the fitted library."""
        self._check_fitted()
        return np.asarray(
            cnmf_reconstruct(jnp.asarray(np.asarray(C, dtype=float)),
                             jnp.asarray(self.synergies_),
                             precision=self.precision)
        )

    def save(self, path):
        """Persist the fitted model as a pickle-free ``.npz``
        (:func:`muscle_synergies_tpu.models.persist.save_model`)."""
        from .persist import save_model

        return save_model(self, path)

    @classmethod
    def load(cls, path) -> "CNMFModel":
        """Load a model saved by :meth:`save` (``allow_pickle=False``;
        safe on untrusted files)."""
        from .persist import load_model

        model = load_model(path)
        if not isinstance(model, cls):
            raise TypeError(
                f"{path} holds a {type(model).__name__}, not {cls.__name__}"
            )
        return model


def tvaf(x: jnp.ndarray, c: jnp.ndarray, s: jnp.ndarray,
         precision=None) -> jnp.ndarray:
    """Overall VAF of the convolutive reconstruction.

    Same definition as the reference's time-invariant ``vaf``
    (reference analysis.py:636-643): ``1 - ||X - X̂||² / ||X||²``.
    Batched factors ``(B, ...)`` return a ``(B,)`` vector.
    """
    rec_fn = functools.partial(cnmf_reconstruct, precision=precision)
    recon = jax.vmap(rec_fn)(c, s) if s.ndim == 4 else rec_fn(c, s)
    sum_axes = tuple(range(x.ndim - 2, x.ndim))
    err = jnp.sum((x - recon) ** 2, axis=sum_axes)
    tot = jnp.sum(x * x, axis=sum_axes)
    return 1.0 - err / jnp.where(tot == 0, 1.0, tot)
