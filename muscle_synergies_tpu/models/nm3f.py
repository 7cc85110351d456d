"""Space-by-time decomposition: sample-based trilinear NMF (NM3F).

The third canonical synergy model of the muscle-synergy literature
(after the reference's time-invariant spatial NMF — reference
analysis.py:848-864 — and :mod:`.cnmf`'s time-varying convolutive
model): Delis, Panzeri, Pozzo & Berret (2014)'s *space-by-time*
factorization writes every trial as a nonnegative mixture of SHARED
temporal modules and SHARED spatial modules with per-trial mixing
coefficients,

    X_b[t, l] ≈ Σ_i Σ_j  W[t, i] · A_b[i, j] · S[j, l]

i.e. ``X_b ≈ W @ A_b @ S`` with ``W (T, P)`` temporal modules,
``S (Q, L)`` spatial modules and ``A_b (P, Q)`` coefficients.  Unlike
per-trial NMF, the modules are estimated from the WHOLE dataset at
once and single small coefficient matrices describe each trial — the
representation Delis et al. use for single-trial decoding.

Device shape: every update below is a batched matmul / einsum over the
trial axis (no scalar loops), the full fit is one
``lax.while_loop`` with the package's sklearn-style stopping, and the
per-trial coefficient update is embarrassingly data-parallel while the
module updates reduce over trials — on a mesh those two reductions
become one psum pair per iteration
(:func:`muscle_synergies_tpu.parallel.sharded_fit_nm3f`).

Multiplicative updates (standard majorize-minimize derivation for each
factor's subproblem, ``EPSILON``-guarded like every solver here):

    A_b ⊙= (Wᵀ X_b Sᵀ) ⊘ (Wᵀ W  A_b  S Sᵀ)
    W   ⊙= (Σ_b X_b Sᵀ A_bᵀ) ⊘ (W · Σ_b A_b (S Sᵀ) A_bᵀ)
    S   ⊙= (Σ_b A_bᵀ Wᵀ X_b) ⊘ ((Σ_b A_bᵀ (Wᵀ W) A_b) · S)

Update order is A, then W, then S (each uses the freshest other
factors), one documented choice pinned by the tests' numpy oracle.

Precision: every public entry point threads a ``precision`` argument
(any ``jax.lax.Precision`` spelling) through all contractions,
including the stopping criterion's error reduction.  ``None`` runs
them at full float32 precision (:func:`~muscle_synergies_tpu.models.mu.full_precision`):
a GPU's default float32 product may round through TF32, which left an
H100 fit 7.5e-3 from the float64 host fit, against 1.6e-6 at full
precision.  ``"default"`` asks for the platform's fast default.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .._optional import is_pandas
from .mu import EPSILON, full_precision

__all__ = [
    "NM3FModel",
    "NM3FState",
    "SharedSpatialResult",
    "SharedTemporalResult",
    "SpaceByTimeResult",
    "find_shared_spatial_synergies",
    "find_space_by_time_synergies",
    "find_temporal_synergies",
    "fit_nm3f",
    "init_nm3f",
    "nm3f_reconstruct",
    "nm3f_transform",
    "nm3f_update",
    "normalize_modules",
    "sbt_vaf",
]


def nm3f_reconstruct(
    w: jnp.ndarray, a: jnp.ndarray, s: jnp.ndarray, precision=None
):
    """``X̂_b = W @ A_b @ S``; ``a`` may be ``(P, Q)`` or ``(B, P, Q)``."""
    if a.ndim == 2:
        return jnp.matmul(
            jnp.matmul(w, a, precision=precision), s, precision=precision
        )
    return jnp.einsum("tp,bpq,ql->btl", w, a, s, precision=precision)


@full_precision
def nm3f_update(
    xs: jnp.ndarray,
    w: jnp.ndarray,
    a: jnp.ndarray,
    s: jnp.ndarray,
    update_w: bool = True,
    update_s: bool = True,
    precision=None,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """One A-then-W-then-S multiplicative update.

    Args:
        xs: ``(B, T, L)`` nonnegative trials (shared time base).
        w: ``(T, P)`` temporal modules.
        a: ``(B, P, Q)`` per-trial coefficients.
        s: ``(Q, L)`` spatial modules.
        update_w / update_s: freeze a module set (the ``transform``
            path fixes both and solves only the coefficients).
        precision: matmul precision for every contraction (see the
            module docstring); ``None`` keeps the XLA default.
    """
    # ---- A update: per-trial, embarrassingly parallel ----
    wtw = jnp.matmul(w.T, w, precision=precision)  # (P, P)
    sst = jnp.matmul(s, s.T, precision=precision)  # (Q, Q)
    num_a = jnp.einsum("tp,btl,ql->bpq", w, xs, s, precision=precision)
    den_a = jnp.einsum(
        "pr,brm,mq->bpq", wtw, a, sst, precision=precision
    )
    a = a * (num_a / jnp.where(den_a == 0, EPSILON, den_a))

    if update_w:
        # ---- W update: trial sums reduce into (T, P) / (P, P) ----
        num_w = jnp.einsum("btl,ql,bpq->tp", xs, s, a, precision=precision)
        gram_w = jnp.einsum(
            "bpq,qm,brm->pr", a, sst, a, precision=precision
        )  # Σ_b A SSᵀ Aᵀ
        den_w = jnp.matmul(w, gram_w, precision=precision)
        w = w * (num_w / jnp.where(den_w == 0, EPSILON, den_w))

    if update_s:
        # ---- S update: trial sums reduce into (Q, L) / (Q, Q) ----
        wtw = jnp.matmul(w.T, w, precision=precision)  # refresh with new W
        num_s = jnp.einsum("bpq,tp,btl->ql", a, w, xs, precision=precision)
        gram_s = jnp.einsum(
            "bpq,pr,brm->qm", a, wtw, a, precision=precision
        )  # Σ_b Aᵀ WᵀW A
        den_s = jnp.matmul(gram_s, s, precision=precision)
        s = s * (num_s / jnp.where(den_s == 0, EPSILON, den_s))
    return w, a, s


class NM3FState(NamedTuple):
    w: jnp.ndarray  # (T, P) temporal modules
    a: jnp.ndarray  # (B, P, Q) per-trial coefficients
    s: jnp.ndarray  # (Q, L) spatial modules
    n_iter: jnp.ndarray
    previous_error: jnp.ndarray
    converged: jnp.ndarray


@full_precision
def _nm3f_error(xs, w, a, s, precision=None):
    diff = xs - nm3f_reconstruct(w, a, s, precision=precision)
    return jnp.sqrt(jnp.sum(diff * diff))


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter", "tol", "check_every", "update_w", "update_s",
        "precision",
    ),
)
def fit_nm3f(
    xs: jnp.ndarray,
    w0: jnp.ndarray,
    a0: jnp.ndarray,
    s0: jnp.ndarray,
    max_iter: int = 500,
    tol: float = 1e-5,
    check_every: int = 10,
    update_w: bool = True,
    update_s: bool = True,
    precision=None,
) -> NM3FState:
    """Run the space-by-time factorization to convergence on device.

    One ``lax.while_loop``; stopping is the package-wide sklearn rule
    (relative total-Frobenius improvement every ``check_every``
    iterations against the initial error).  ``precision`` (static,
    hashable — e.g. ``"highest"``) threads through the update
    contractions; see the module docstring.  The stopping criterion's
    error checks default to ``jax.lax.Precision.HIGHEST`` regardless
    (a reduced-precision statistic flips near-threshold stopping
    decisions) — an explicit ``precision`` applies to the checks too.
    """
    xs = jnp.asarray(xs)
    check_precision = (
        precision if precision is not None else jax.lax.Precision.HIGHEST
    )
    error_init = _nm3f_error(xs, w0, a0, s0, precision=check_precision)

    def cond(state: NM3FState):
        return (state.n_iter < max_iter) & ~state.converged

    def body(state: NM3FState):
        # max_iter is a hard cap, as everywhere in the solver family:
        # the tail chunk runs max_iter % check_every updates
        steps = jnp.minimum(check_every, max_iter - state.n_iter)

        def one(_, was):
            return nm3f_update(
                xs, *was, update_w=update_w, update_s=update_s,
                precision=precision,
            )

        w, a, s = jax.lax.fori_loop(
            0, steps, one, (state.w, state.a, state.s)
        )
        n_iter = state.n_iter + steps
        error = _nm3f_error(xs, w, a, s, precision=check_precision)
        improvement = (state.previous_error - error) / jnp.maximum(
            error_init, EPSILON
        )
        converged = jnp.logical_and(
            improvement < tol, n_iter % check_every == 0
        )
        return NM3FState(w, a, s, n_iter, error, converged)

    init = NM3FState(
        w0.astype(xs.dtype),
        a0.astype(xs.dtype),
        s0.astype(xs.dtype),
        jnp.asarray(0, jnp.int32),
        error_init,
        jnp.asarray(False),
    )
    return jax.lax.while_loop(cond, body, init)


def init_nm3f(
    xs: np.ndarray,
    n_temporal: int,
    n_spatial: int,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Scaled-random nonnegative init for ``(W, A, S)``.

    Each factor entry is uniform with mean ``c`` chosen so the expected
    reconstruction magnitude matches the data:
    ``E[X̂] ≈ P·Q·c³ = mean(X)``.
    """
    xs = np.asarray(xs)
    b, t, l = xs.shape
    rng = np.random.default_rng(seed)
    c = (
        float(max(xs.mean(), 0.0)) / (n_temporal * n_spatial)
    ) ** (1.0 / 3.0) if xs.size else 1.0
    w = rng.uniform(0, 2 * c, size=(t, n_temporal))
    a = rng.uniform(0, 2 * c, size=(b, n_temporal, n_spatial))
    s = rng.uniform(0, 2 * c, size=(n_spatial, l))
    dt = xs.dtype if np.issubdtype(xs.dtype, np.floating) else np.float64
    return (
        w.astype(dt, copy=False),
        a.astype(dt, copy=False),
        s.astype(dt, copy=False),
    )


def normalize_modules(
    w: jnp.ndarray, a: jnp.ndarray, s: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Unit-norm modules, per-trial coefficients rescaled inversely.

    Temporal module columns and spatial module rows get unit Euclidean
    norm; the scale moves into ``A`` (``A'_b = diag(||w_i||) A_b
    diag(||s_j||)``), leaving every reconstruction unchanged up to two
    multiplies.  Zero modules are left untouched.
    """
    wn = jnp.sqrt(jnp.sum(w * w, axis=0))  # (P,)
    sn = jnp.sqrt(jnp.sum(s * s, axis=1))  # (Q,)
    w_out = w / jnp.where(wn == 0, 1.0, wn)[None, :]
    s_out = s / jnp.where(sn == 0, 1.0, sn)[:, None]
    a_out = a * wn[:, None] * sn[None, :]
    return w_out, a_out, s_out


def sbt_vaf(
    xs: jnp.ndarray,
    w: jnp.ndarray,
    a: jnp.ndarray,
    s: jnp.ndarray,
    precision=None,
):
    """Per-trial VAF of the space-by-time reconstruction, ``(B,)``."""
    rec = nm3f_reconstruct(w, a, s, precision=precision)
    err = jnp.sum((xs - rec) ** 2, axis=(1, 2))
    tot = jnp.sum(xs * xs, axis=(1, 2))
    return 1.0 - err / jnp.where(tot == 0, 1.0, tot)


def nm3f_transform(
    x: jnp.ndarray,
    w: jnp.ndarray,
    s: jnp.ndarray,
    a0: jnp.ndarray = None,
    max_iter: int = 200,
    tol: float = 1e-4,
    seed: int = 0,
    precision=None,
) -> NM3FState:
    """Project trials onto FIXED modules: solve A, freeze W and S.

    The space-by-time analog of ``NMFModel.transform`` (sklearn
    ``NMF.transform`` runs the same updates with the components frozen;
    the reference reaches it through sklearn, reference
    analysis.py:848-864) and the single-trial-decoding step of Delis
    et al. (2014): given shared temporal/spatial modules from a prior
    fit, recover the per-trial mixing coefficients of *new* trials on
    the SAME time base (``W`` pins the number of samples ``T``).

    Args:
        x: ``(T, L)`` or batched ``(B, T, L)`` nonnegative trials.
        w: ``(T, P)`` fixed temporal modules.
        s: ``(Q, L)`` fixed spatial modules.
        a0: optional initial coefficients ``(B, P, Q)``; defaults to a
            scaled-random init matched to the data magnitude.
        max_iter / tol: sklearn-style stopping on the Frobenius error.

    Returns:
        :class:`NM3FState` whose ``w`` and ``s`` equal the inputs
        bit-for-bit; ``a`` holds the solved coefficients.
    """
    x = jnp.asarray(x)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    w = jnp.asarray(w)
    s = jnp.asarray(s)
    b = x.shape[0]
    p, q = w.shape[1], s.shape[0]
    if a0 is None:
        # E[X̂] over (t, l) with A ≡ c is c·(ΣW)(ΣS)/(T·L); match it to
        # the data mean so the first multiplicative steps are O(1).
        # Computed on device (JAX PRNG, traced mean) so the transform
        # stays jittable/exportable with no host readback.
        import jax

        t, l = x.shape[1], x.shape[2]
        denom = jnp.sum(w) * jnp.sum(s)
        c = jnp.where(
            denom > 0,
            jnp.mean(x) * t * l / jnp.maximum(denom, EPSILON),
            1.0,
        )
        c = jnp.maximum(c, EPSILON)
        u = jax.random.uniform(
            jax.random.PRNGKey(seed), (b, p, q), dtype=x.dtype
        )
        a0 = u * (2.0 * c).astype(x.dtype)
    else:
        a0 = jnp.asarray(a0)
        if a0.ndim == 2:
            # one init matrix broadcast across the batch
            a0 = jnp.broadcast_to(a0[None], (b,) + a0.shape)
        elif a0.shape[0] != b:
            raise ValueError(
                f"a0 has batch {a0.shape[0]} but x has {b} trials"
            )
    state = fit_nm3f(
        x, w, a0, s, max_iter=max_iter, tol=tol, check_every=10,
        update_w=False, update_s=False, precision=precision,
    )
    if squeeze:
        state = state._replace(a=state.a[0])
    return state


class SpaceByTimeResult(NamedTuple):
    """Best-restart result of :func:`find_space_by_time_synergies`.

    Attributes:
        temporal_modules: ``(T, P)`` DataFrame, unit-norm columns.
        spatial_modules: ``(Q, L)`` DataFrame, unit-norm rows, columns
            named after the muscles.
        coefficients: ``(B, P, Q)`` per-trial mixing coefficients.
        vaf: overall VAF across the dataset (scalar float).
        vaf_per_trial: ``(B,)`` array.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
    """

    temporal_modules: object
    spatial_modules: object
    coefficients: np.ndarray
    vaf: float
    vaf_per_trial: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


def _fit_restarts_meshed(xs_np, inits, mesh, max_iter, tol, precision=None):
    """Sharded restart fits for :func:`find_space_by_time_synergies`.

    One :func:`~muscle_synergies_tpu.parallel.sharded_fit_nm3f` call
    per restart (the shared modules make each restart a separate
    GLOBAL problem, so restarts cannot stack on the data axis the way
    the per-trial solvers' grids do); states come back stacked on a
    leading restart axis, matching the local vmapped layout.

    Trial counts that don't divide the data axis are zero-padded:
    zero trials with zero coefficients contribute exactly nothing to
    any numerator, Gram, or error sum (their ``A`` rows stay
    identically zero under the multiplicative update), so the padded
    problem's W/S/error match the unpadded one bit-for-bit up to psum
    reordering.  Returns ``None`` (caller falls back to the local
    path, with a warning) when the time axis doesn't divide.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import DATA_AXIS, TIME_AXIS
    from ..parallel.nm3f import sharded_fit_nm3f

    def _fall_back(reason):
        import warnings

        warnings.warn(
            f"find_space_by_time_synergies: {reason}; falling back to "
            "the local single-device solver.",
            stacklevel=3,
        )
        return None

    missing = {DATA_AXIS, TIME_AXIS} - set(mesh.axis_names)
    if missing:
        return _fall_back(
            f"mesh {mesh.axis_names} lacks the "
            f"{sorted(missing)} axis (a (data, time) mesh is required)"
        )
    b, t, _ = xs_np.shape
    n_time = mesh.shape[TIME_AXIS]
    if t % n_time:
        return _fall_back(
            f"trial length {t} must divide over the mesh's "
            f"{n_time}-way time axis"
        )
    n_data = mesh.shape[DATA_AXIS]
    pad = (-b) % n_data
    if pad:
        xs_np = np.concatenate(
            [xs_np, np.zeros((pad,) + xs_np.shape[1:], xs_np.dtype)]
        )
    xs_dev = jax.device_put(
        jnp.asarray(xs_np), NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS))
    )
    states = []
    for w0, a0, s0 in inits:
        if pad:
            a0 = np.concatenate(
                [a0, np.zeros((pad,) + a0.shape[1:], a0.dtype)]
            )
        st = sharded_fit_nm3f(
            xs_dev,
            jax.device_put(
                jnp.asarray(w0), NamedSharding(mesh, P(TIME_AXIS))
            ),
            jax.device_put(
                jnp.asarray(a0), NamedSharding(mesh, P(DATA_AXIS))
            ),
            jnp.asarray(s0),
            mesh, max_iter=max_iter, tol=tol, precision=precision,
        )
        if pad:
            st = st._replace(a=st.a[:b])
        states.append(st)
    return jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves), *states
    )


def _space_by_time(
    trials, n_temporal, n_spatial, max_iter, tol, n_inits, seed, mesh,
    precision,
):
    """Array core of :func:`find_space_by_time_synergies`.

    Returns ``(result, columns)``: the result carries numpy arrays in
    place of the module DataFrames, and ``columns`` the input's column
    labels (or ``None``).
    """
    columns = None
    if not hasattr(trials, "ndim"):
        first = trials[0]
        if is_pandas(first):
            columns = list(first.columns)
        trials = np.stack([np.asarray(t) for t in trials])
    # keep the caller's float dtype (f32 stacks solve in f32 — the
    # package-wide dtype-explicit convention); promote ints to f64
    xs = np.asarray(trials)
    if not np.issubdtype(xs.dtype, np.floating):
        xs = xs.astype(np.float64)
    if xs.ndim != 3:
        raise ValueError(
            f"expected a (B, T, L) trial stack, got shape {xs.shape}"
        )
    if xs.size == 0:
        raise ValueError("empty trial stack passed to NM3F")
    if not np.all(np.isfinite(xs)):
        raise ValueError("Input X contains NaN or infinity.")
    if np.any(xs < 0):
        raise ValueError("Negative values in data passed to NMF")
    b, t, l = xs.shape
    if not 1 <= n_temporal <= t:
        raise ValueError(
            f"n_temporal must be in [1, n_samples={t}], got {n_temporal}"
        )
    if not 1 <= n_spatial <= l:
        raise ValueError(
            f"n_spatial must be in [1, n_muscles={l}], got {n_spatial}"
        )
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")

    inits = [
        init_nm3f(xs, n_temporal, n_spatial, seed=seed + r)
        for r in range(n_inits)
    ]
    xs_dev = jnp.asarray(xs)

    states = None
    if mesh is not None:
        states = _fit_restarts_meshed(
            xs, inits, mesh, max_iter, tol, precision=precision
        )
    if states is None:
        w0 = jnp.asarray(np.stack([i[0] for i in inits]))
        a0 = jnp.asarray(np.stack([i[1] for i in inits]))
        s0 = jnp.asarray(np.stack([i[2] for i in inits]))
        states = jax.vmap(
            lambda w, a, s: fit_nm3f(
                xs_dev, w, a, s, max_iter=max_iter, tol=tol,
                precision=precision,
            )
        )(w0, a0, s0)

    errors = np.asarray(states.previous_error)
    best = int(np.argmin(errors))
    w, a, s = normalize_modules(
        states.w[best], states.a[best], states.s[best]
    )
    rec = nm3f_reconstruct(w, a, s, precision=precision)
    err2 = jnp.sum((xs_dev - rec) ** 2, axis=(1, 2))
    tot2 = jnp.sum(xs_dev * xs_dev, axis=(1, 2))
    per_trial = np.asarray(1.0 - err2 / jnp.where(tot2 == 0, 1.0, tot2))
    overall = 1.0 - float(jnp.sum(err2)) / max(
        float(jnp.sum(tot2)), float(EPSILON)
    )

    result = SpaceByTimeResult(
        temporal_modules=np.asarray(w),
        spatial_modules=np.asarray(s),
        coefficients=np.asarray(a),
        vaf=overall,
        vaf_per_trial=per_trial,
        n_iter=int(states.n_iter[best]),
        restart_errors=errors,
    )
    return result, columns


def find_space_by_time_synergies(
    trials,
    n_temporal: int,
    n_spatial: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    mesh=None,
    precision=None,
) -> SpaceByTimeResult:
    """Extract Delis-style space-by-time synergies from a trial stack.

    The dataset-level companion to ``find_synergies`` (spatial-only)
    and :func:`~muscle_synergies_tpu.models.cnmf.find_time_varying_synergies`
    (temporal-extent-only): shared temporal AND spatial modules with a
    small per-trial coefficient matrix each.  The ``n_inits`` random
    restarts are vmapped into ONE device computation; the lowest-error
    restart is returned with unit-norm modules.

    Args:
        trials: ``(B, T, L)`` nonnegative stack (e.g. the output of
            :func:`muscle_synergies_tpu.dataset.preprocess_trials`), or
            a sequence of equal-shape ``(T, L)`` DataFrames/arrays.
        n_temporal / n_spatial: module counts ``P`` / ``Q``.
        max_iter / tol: sklearn-style stopping (see :func:`fit_nm3f`).
        n_inits: random restarts (batched into one computation).
        seed: base seed; restart ``r`` uses ``seed + r``.
        mesh: optional ``(data, time)`` mesh — each restart runs
            through :func:`~muscle_synergies_tpu.parallel.sharded_fit_nm3f`
            (trials and coefficients over ``data``, the shared time
            base over ``time``); trial counts that don't divide the
            data axis are exactly zero-padded, and a non-dividing time
            axis warns and falls back to the local solver.
        precision: matmul precision for every contraction (e.g.
            ``"highest"`` for full float32 products); see the module
            docstring.
    """
    res, columns = _space_by_time(
        trials, n_temporal, n_spatial, max_iter, tol, n_inits, seed, mesh,
        precision,
    )
    import pandas

    n_muscles = res.spatial_modules.shape[1]
    cols = columns if columns is not None else list(range(n_muscles))
    return res._replace(
        temporal_modules=pandas.DataFrame(
            res.temporal_modules,
            columns=[f"temporal {i}" for i in range(n_temporal)],
        ),
        spatial_modules=pandas.DataFrame(res.spatial_modules, columns=cols),
    )


class NM3FModel:
    """sklearn-style estimator for the space-by-time synergy model.

    The trilinear companion to
    :class:`muscle_synergies_tpu.models.select.NMFModel` and
    :class:`muscle_synergies_tpu.models.cnmf.CNMFModel` (the reference
    has no space-by-time surface at all — beyond-reference capability):
    ``fit`` / ``fit_transform`` estimate shared temporal and spatial
    modules from a whole trial stack with batched multi-restart via
    :func:`find_space_by_time_synergies`; ``transform`` solves the
    per-trial mixing coefficients of NEW trials with both module sets
    frozen (:func:`nm3f_transform`) — the representation Delis et al.
    (2014) decode single trials from.

    Attributes after fitting:
        temporal_modules_: ``(T, P)`` unit-norm columns.
        spatial_modules_: ``(Q, L)`` unit-norm rows.
        n_temporal_ / n_spatial_: module counts actually used.
        n_iter_: iterations of the winning restart.
        reconstruction_err_: its final Frobenius error.
        restart_errors_: ``(n_inits,)`` final errors of all restarts.
        vaf_: overall VAF of the training reconstruction.
    """

    def __init__(
        self,
        n_temporal: int,
        n_spatial: int,
        *,
        tol: float = 1e-5,
        max_iter: int = 500,
        n_inits: int = 4,
        random_state: int = 0,
        precision=None,
    ):
        self.n_temporal = n_temporal
        self.n_spatial = n_spatial
        self.tol = tol
        self.max_iter = max_iter
        self.n_inits = n_inits
        self.random_state = random_state
        self.precision = precision

    def _set_fitted(self, res) -> None:
        self.temporal_modules_ = np.asarray(res.temporal_modules)
        self.spatial_modules_ = np.asarray(res.spatial_modules)
        self.n_temporal_ = self.n_temporal
        self.n_spatial_ = self.n_spatial
        self.n_iter_ = int(res.n_iter)
        self.restart_errors_ = res.restart_errors
        self.reconstruction_err_ = float(res.restart_errors.min())
        # SpaceByTimeResult spells it `vaf`; the dataset-level
        # SpaceByTimeDatasetResult spells it `vaf_overall`
        self.vaf_ = float(
            res.vaf if hasattr(res, "vaf") else res.vaf_overall
        )

    def fit_transform(self, X) -> np.ndarray:
        """Fit the modules and return the ``(B, P, Q)`` coefficients."""
        res, _ = _space_by_time(
            X, self.n_temporal, self.n_spatial, self.max_iter, self.tol,
            self.n_inits, self.random_state, None, self.precision,
        )
        self._set_fitted(res)
        return res.coefficients

    def fit(self, X) -> "NM3FModel":
        self.fit_transform(X)
        return self

    @classmethod
    def from_result(cls, res, **kwargs) -> "NM3FModel":
        """Wrap a :func:`find_space_by_time_synergies` result (or the
        dataset-level ``SpaceByTimeDatasetResult``) as a fitted
        estimator (e.g. to ``save`` it or ``transform`` new trials
        without refitting).  ``kwargs`` are the constructor
        hyperparameters the result was produced with."""
        model = cls(
            res.temporal_modules.shape[1], res.spatial_modules.shape[0],
            **kwargs,
        )
        model._set_fitted(res)
        return model

    @classmethod
    def from_temporal_result(
        cls, res: "SharedTemporalResult", **kwargs
    ) -> "NM3FModel":
        """Wrap a :func:`find_temporal_synergies` (tMod) result as a
        fitted estimator.

        tMod is the exact NM3F specialization with the spatial side
        frozen at identity, so the estimator carries
        ``spatial_modules_ = eye(L)``; ``transform`` then solves each
        new trial's ``(P, L)`` muscle weighting against the shared
        temporal modules — the tMod single-trial decoding step.
        """
        n_muscles = res.weights.shape[-1]
        model = cls(res.temporal_modules.shape[1], n_muscles, **kwargs)
        model.temporal_modules_ = res.temporal_modules.to_numpy()
        model.spatial_modules_ = np.eye(
            n_muscles, dtype=model.temporal_modules_.dtype
        )
        model.n_temporal_ = model.n_temporal
        model.n_spatial_ = n_muscles
        model.n_iter_ = int(res.n_iter)
        model.restart_errors_ = res.restart_errors
        model.reconstruction_err_ = float(res.restart_errors.min())
        model.vaf_ = float(res.vaf)
        return model

    @classmethod
    def from_shared_spatial_result(
        cls, res: "SharedSpatialResult", **kwargs
    ) -> "NM3FModel":
        """Wrap a :func:`find_shared_spatial_synergies` (sMod) result
        as a fitted estimator.

        sMod freezes the temporal side at identity, so the estimator
        carries ``temporal_modules_ = eye(T)``; ``transform`` solves
        each new trial's ``(T, Q)`` activations against the shared
        spatial modules — the sMod single-trial decoding step.
        """
        n_samples = res.activations.shape[1]
        model = cls(n_samples, res.spatial_modules.shape[0], **kwargs)
        model.spatial_modules_ = res.spatial_modules.to_numpy()
        model.temporal_modules_ = np.eye(
            n_samples, dtype=model.spatial_modules_.dtype
        )
        model.n_temporal_ = n_samples
        model.n_spatial_ = model.n_spatial
        model.n_iter_ = int(res.n_iter)
        model.restart_errors_ = res.restart_errors
        model.reconstruction_err_ = float(res.restart_errors.min())
        model.vaf_ = float(res.vaf)
        return model

    def _check_fitted(self):
        if not hasattr(self, "temporal_modules_"):
            raise ValueError(
                "this NM3FModel instance is not fitted yet; call fit "
                "or fit_transform first"
            )

    def transform(self, X) -> np.ndarray:
        """Coefficients of new trials against the FITTED modules.

        New trials must share the training time base (``W`` is a
        ``(T, P)`` matrix over a fixed ``T`` — time-normalize trials
        to the same sample count first, as the fit did).
        """
        self._check_fitted()
        x = np.asarray(X, dtype=float)
        if x.ndim not in (2, 3):
            raise ValueError(
                f"expected (T, L) or (B, T, L) trials, got shape {x.shape}"
            )
        if x.shape[-2] != self.temporal_modules_.shape[0]:
            raise ValueError(
                f"trials have {x.shape[-2]} samples but the fitted "
                f"temporal modules expect "
                f"{self.temporal_modules_.shape[0]}"
            )
        return np.asarray(self._transform_jax(jnp.asarray(x)))

    def _transform_jax(self, x: jnp.ndarray) -> jnp.ndarray:
        """Pure-JAX transform: coefficients with both modules frozen.

        Traceable/jittable (and therefore exportable through
        :mod:`muscle_synergies_tpu.models.export`)."""
        self._check_fitted()
        state = nm3f_transform(
            x, jnp.asarray(self.temporal_modules_, dtype=x.dtype),
            jnp.asarray(self.spatial_modules_, dtype=x.dtype),
            max_iter=self.max_iter, tol=self.tol,
            seed=self.random_state, precision=self.precision,
        )
        return state.a

    def inverse_transform(self, A) -> np.ndarray:
        """Reconstruction ``X̂`` from coefficients and fitted modules."""
        self._check_fitted()
        return np.asarray(
            nm3f_reconstruct(
                jnp.asarray(self.temporal_modules_),
                jnp.asarray(np.asarray(A, dtype=float)),
                jnp.asarray(self.spatial_modules_),
                precision=self.precision,
            )
        )

    def save(self, path):
        """Persist the fitted model as a pickle-free ``.npz``
        (:func:`muscle_synergies_tpu.models.persist.save_model`)."""
        from .persist import save_model

        return save_model(self, path)

    @classmethod
    def load(cls, path) -> "NM3FModel":
        """Load a model saved by :meth:`save` (``allow_pickle=False``;
        safe on untrusted files)."""
        from .persist import load_model

        model = load_model(path)
        if not isinstance(model, cls):
            raise TypeError(
                f"{path} holds a {type(model).__name__}, not {cls.__name__}"
            )
        return model


class SharedTemporalResult(NamedTuple):
    """Best-restart result of :func:`find_temporal_synergies`.

    Attributes:
        temporal_modules: ``(T, P)`` DataFrame, unit-norm columns.
        weights: ``(B, P, L)`` per-trial muscle weightings of each
            module.
        vaf: overall VAF across the dataset.
        vaf_per_trial: ``(B,)``.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
    """

    temporal_modules: object
    weights: np.ndarray
    vaf: float
    vaf_per_trial: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


class SharedSpatialResult(NamedTuple):
    """Best-restart result of :func:`find_shared_spatial_synergies`.

    Attributes:
        spatial_modules: ``(Q, L)`` DataFrame, unit-norm rows, columns
            named after the muscles when the input carries labels.
        activations: ``(B, T, Q)`` per-trial recruitment of each
            module over time.
        vaf: overall VAF across the dataset.
        vaf_per_trial: ``(B,)``.
        n_iter: iterations used by the winning restart.
        restart_errors: ``(n_inits,)`` final errors of all restarts.
    """

    spatial_modules: object
    activations: np.ndarray
    vaf: float
    vaf_per_trial: np.ndarray
    n_iter: int
    restart_errors: np.ndarray


def _validate_trial_stack(trials):
    """Shared (B, T, L) stack validation; returns (xs, columns)."""
    columns = None
    if not hasattr(trials, "ndim"):
        first = trials[0]
        if is_pandas(first):
            columns = list(first.columns)
        trials = np.stack([np.asarray(t) for t in trials])
    xs = np.asarray(trials)
    if not np.issubdtype(xs.dtype, np.floating):
        xs = xs.astype(np.float64)
    if xs.ndim != 3:
        raise ValueError(
            f"expected a (B, T, L) trial stack, got shape {xs.shape}"
        )
    if xs.size == 0:
        raise ValueError("empty trial stack")
    if not np.all(np.isfinite(xs)):
        raise ValueError("Input X contains NaN or infinity.")
    if np.any(xs < 0):
        raise ValueError("Negative values in data passed to NMF")
    return xs, columns


def _fit_frozen_restarts(
    xs, inits_w, inits_a, inits_s, max_iter, tol, update_w, update_s,
    precision=None,
):
    """vmapped restarts of :func:`fit_nm3f` with one factor frozen."""
    w0 = jnp.asarray(np.stack(inits_w))
    a0 = jnp.asarray(np.stack(inits_a))
    s0 = jnp.asarray(np.stack(inits_s))
    xs_dev = jnp.asarray(xs)
    return jax.vmap(
        lambda w, a, s: fit_nm3f(
            xs_dev, w, a, s, max_iter=max_iter, tol=tol,
            update_w=update_w, update_s=update_s, precision=precision,
        )
    )(w0, a0, s0)


def find_temporal_synergies(
    trials,
    n_temporal: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    precision=None,
) -> SharedTemporalResult:
    """Extract SHARED temporal modules with per-trial muscle weights.

    Delis et al. (2014)'s *temporal* decomposition (the "tMod" of
    their unifying taxonomy; the other two members — the shared-
    spatial "sMod" and the full space-by-time model — are
    :func:`find_shared_spatial_synergies` and
    :func:`find_space_by_time_synergies`):

        ``X_b[t, l] ≈ Σ_i W[t, i] · A_b[i, l]``

    i.e. the exact space-by-time model with the spatial side frozen at
    identity (``Q = L``, ``S = I``) — every trial recruits the SAME
    temporal waveforms with its own muscle weighting.  Runs as one
    vmapped multi-restart :func:`fit_nm3f` with ``update_s=False``;
    the frozen identity passes through bit-for-bit.
    """
    xs, _ = _validate_trial_stack(trials)
    b, t, l = xs.shape
    if not 1 <= n_temporal <= t:
        raise ValueError(
            f"n_temporal must be in [1, n_samples={t}], got {n_temporal}"
        )
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")

    eye = np.eye(l, dtype=xs.dtype)
    # random (W, A) scaled for S = I: E[X̂] ≈ P·c² = mean(X)
    c = (float(max(xs.mean(), 0.0)) / n_temporal) ** 0.5 if xs.size else 1.0
    rng = np.random.default_rng(seed)
    inits_w = [rng.uniform(0, 2 * c, (t, n_temporal)).astype(xs.dtype)
               for _ in range(n_inits)]
    inits_a = [rng.uniform(0, 2 * c, (b, n_temporal, l)).astype(xs.dtype)
               for _ in range(n_inits)]
    states = _fit_frozen_restarts(
        xs, inits_w, inits_a, [eye] * n_inits, max_iter, tol,
        update_w=True, update_s=False, precision=precision,
    )

    errors = np.asarray(states.previous_error)
    best = int(np.argmin(errors))
    w, a, s = normalize_modules(
        states.w[best], states.a[best], states.s[best]
    )
    per_trial = np.asarray(
        sbt_vaf(jnp.asarray(xs), w, a, s, precision=precision)
    )
    rec = nm3f_reconstruct(w, a, s, precision=precision)
    err2 = float(jnp.sum((jnp.asarray(xs) - rec) ** 2))
    tot2 = float(jnp.sum(jnp.asarray(xs) ** 2))
    import pandas

    return SharedTemporalResult(
        temporal_modules=pandas.DataFrame(
            np.asarray(w),
            columns=[f"temporal {i}" for i in range(n_temporal)],
        ),
        weights=np.asarray(a),
        vaf=1.0 - err2 / max(tot2, float(EPSILON)),
        vaf_per_trial=per_trial,
        n_iter=int(states.n_iter[best]),
        restart_errors=errors,
    )


def find_shared_spatial_synergies(
    trials,
    n_spatial: int,
    max_iter: int = 500,
    tol: float = 1e-5,
    n_inits: int = 4,
    seed: int = 0,
    precision=None,
) -> SharedSpatialResult:
    """Extract SHARED spatial modules with per-trial activations.

    Delis et al. (2014)'s *spatial* decomposition ("sMod"): the
    dataset-level twin of the reference's per-trial spatial NMF
    (reference analysis.py:848-864 fits each trial its own
    components; here ONE module set explains every trial):

        ``X_b[t, l] ≈ Σ_j C_b[t, j] · S[j, l]``

    i.e. the space-by-time model with the temporal side frozen at
    identity (``P = T``, ``W = I``).  Runs as one vmapped
    multi-restart :func:`fit_nm3f` with ``update_w=False``; the
    frozen identity passes through bit-for-bit.
    """
    xs, columns = _validate_trial_stack(trials)
    b, t, l = xs.shape
    if not 1 <= n_spatial <= l:
        raise ValueError(
            f"n_spatial must be in [1, n_muscles={l}], got {n_spatial}"
        )
    if n_inits < 1:
        raise ValueError(f"n_inits must be >= 1, got {n_inits}")

    eye = np.eye(t, dtype=xs.dtype)
    c = (float(max(xs.mean(), 0.0)) / n_spatial) ** 0.5 if xs.size else 1.0
    rng = np.random.default_rng(seed)
    inits_a = [rng.uniform(0, 2 * c, (b, t, n_spatial)).astype(xs.dtype)
               for _ in range(n_inits)]
    inits_s = [rng.uniform(0, 2 * c, (n_spatial, l)).astype(xs.dtype)
               for _ in range(n_inits)]
    states = _fit_frozen_restarts(
        xs, [eye] * n_inits, inits_a, inits_s, max_iter, tol,
        update_w=False, update_s=True, precision=precision,
    )

    errors = np.asarray(states.previous_error)
    best = int(np.argmin(errors))
    w, a, s = states.w[best], states.a[best], states.s[best]
    # unit-norm the spatial rows only (W is the frozen identity)
    sn = jnp.sqrt(jnp.sum(s * s, axis=1))
    s_out = s / jnp.where(sn == 0, 1.0, sn)[:, None]
    a_out = a * sn[None, None, :]
    per_trial = np.asarray(
        sbt_vaf(jnp.asarray(xs), w, a_out, s_out, precision=precision)
    )
    rec = nm3f_reconstruct(w, a_out, s_out, precision=precision)
    err2 = float(jnp.sum((jnp.asarray(xs) - rec) ** 2))
    tot2 = float(jnp.sum(jnp.asarray(xs) ** 2))
    import pandas

    cols = columns if columns is not None else list(range(l))
    return SharedSpatialResult(
        spatial_modules=pandas.DataFrame(np.asarray(s_out), columns=cols),
        activations=np.asarray(a_out),
        vaf=1.0 - err2 / max(tot2, float(EPSILON)),
        vaf_per_trial=per_trial,
        n_iter=int(states.n_iter[best]),
        restart_errors=errors,
    )
