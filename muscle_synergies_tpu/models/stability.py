"""Synergy stability and principled rank selection.

Beyond-reference capability (BASELINE.json config 5): the reference
selects rank by eyeballing VAF sweeps only.  This module adds:

- :func:`bootstrap_synergies`: refit NMF on bootstrap resamples of the
  time axis — **as one vmapped batch** — and score each reference
  component's stability as its best-matching cosine similarity across
  resamples (Hungarian matching per resample);
- :func:`fit_mu_masked`: weighted (masked) multiplicative updates,
  the EM treatment of missing entries:
  ``W *= ((M*X) Ht) / ((M*(WH)) Ht)`` and symmetrically for H;
- :func:`cv_rank_selection`: Wold-style cross-validation — hold out
  random matrix entries, fit on the rest with masked MU, score the
  held-out reconstruction error per rank.  All ``(repeat, rank)``
  fits run in a single vmapped computation via rank zero-padding.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .init import initialize_nmf
from .mu import EPSILON, MUState, full_precision
from .batch import _pad_rank

__all__ = [
    "bootstrap_synergies",
    "BootstrapResult",
    "fit_mu_masked",
    "cv_rank_selection",
    "CVResult",
    "bootstrap_time_varying_synergies",
    "TimeVaryingBootstrapResult",
    "fit_cnmf_masked",
    "cv_time_varying_rank_selection",
    "bootstrap_space_by_time",
    "fit_nm3f_masked",
    "cv_space_by_time_selection",
    "SpaceByTimeCVResult",
    "cv_temporal_selection",
    "cv_shared_spatial_selection",
    "bootstrap_temporal_synergies",
    "bootstrap_shared_spatial_synergies",
    "match_synergies",
    "SynergyMatch",
    "cluster_synergies",
    "SynergyClusters",
]


# ---------------------------------------------------------------------------
# bootstrap stability
# ---------------------------------------------------------------------------

@dataclass
class BootstrapResult:
    """Per-component stability of a synergy factorization.

    Attributes:
        reference_components: ``(k, L)`` components of the full fit.
        similarities: ``(n_boot, k)`` matched cosine similarity of each
            reference component in each bootstrap refit.
        mean / std: per-component summary across resamples.
    """

    reference_components: np.ndarray
    similarities: np.ndarray

    @property
    def mean(self) -> np.ndarray:
        return self.similarities.mean(axis=0)

    @property
    def std(self) -> np.ndarray:
        return self.similarities.std(axis=0)


def _match_components(h_ref: np.ndarray, h_boot: np.ndarray) -> np.ndarray:
    """Best-assignment cosine similarity of each reference component."""
    from scipy.optimize import linear_sum_assignment

    def normalize(h):
        norm = np.linalg.norm(h, axis=1, keepdims=True)
        return h / np.where(norm == 0, 1.0, norm)

    sim = normalize(h_ref) @ normalize(h_boot).T  # (k, k)
    rows, cols = linear_sum_assignment(-sim)
    matched = np.zeros(h_ref.shape[0])
    matched[rows] = sim[rows, cols]
    return matched


def bootstrap_synergies(
    x,
    n_components: int,
    n_boot: int = 50,
    seed: int = 0,
    init: Optional[str] = None,
    max_iter: int = 500,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
) -> BootstrapResult:
    """Bootstrap the time axis and measure component stability.

    All resamples factorize in one vmapped solver call; only the
    k x k component matching runs on host.  With ``mesh`` (a
    ``(data, time)`` mesh from :func:`~...parallel.make_mesh`) the
    resample batch runs through the sharded solver instead — resamples
    shard over ``data`` (duplicate-padded to divisibility, exact: every
    fit is independent), samples over ``time``; an indivisible sample
    count falls back to the local batch with a warning, as
    ``analyze_dataset`` does.
    """
    from .batch import fit_mu_batch, init_batch

    x = jnp.asarray(np.asarray(x, dtype=float))
    n = x.shape[0]

    # full fit = reference components
    w0, h0 = initialize_nmf(x, n_components, init=init, seed=seed)
    from .mu import fit_mu

    ref = fit_mu(x, w0, h0, max_iter=max_iter, tol=tol)
    h_ref = np.asarray(ref.h)

    if _resample_plan is None:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, n, size=(n_boot, n))
    else:
        # resume plumbing (models.resume): precomputed index rows for
        # this chunk; the init here is per-trial-deterministic so no
        # global row offset is needed
        idx, _ = _resample_plan
        n_boot = idx.shape[0]
    xb = x[jnp.asarray(idx)]  # (n_boot, N, L)
    w0b, h0b = init_batch(xb, n_components, init=init, seed=seed)

    if mesh is not None:
        from ..dataset import _usable_mesh

        mesh = _usable_mesh(mesh, "bootstrap_synergies")
    mesh_divides = mesh is not None and n % mesh.shape.get("time", 1) == 0
    if mesh is not None and not mesh_divides:
        import warnings

        warnings.warn(
            f"bootstrap_synergies: sample count {n} does not divide "
            f"over the mesh's {mesh.shape.get('time', 1)}-way time "
            "axis; falling back to the local batched solver.",
            stacklevel=2,
        )
    if mesh_divides:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.mesh import DATA_AXIS, TIME_AXIS
        from ..parallel.nmf import sharded_fit_mu

        pad = (-n_boot) % mesh.shape[DATA_AXIS]
        if pad:
            xb = jnp.concatenate(
                [xb, jnp.repeat(xb[:1], pad, axis=0)], axis=0
            )
            w0b = jnp.concatenate(
                [w0b, jnp.repeat(w0b[:1], pad, axis=0)], axis=0
            )
            h0b = jnp.concatenate(
                [h0b, jnp.repeat(h0b[:1], pad, axis=0)], axis=0
            )
        xb = jax.device_put(
            xb, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        w0b = jax.device_put(
            w0b, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        h0b = jax.device_put(
            h0b, NamedSharding(mesh, P(DATA_AXIS, None, None))
        )
        states = sharded_fit_mu(
            xb, w0b, h0b, mesh, max_iter=max_iter, tol=tol
        )
        hs = np.asarray(states.h)[:n_boot]
    else:
        states = fit_mu_batch(xb, w0b, h0b, max_iter=max_iter, tol=tol)
        hs = np.asarray(states.h)

    sims = np.stack([_match_components(h_ref, hs[b]) for b in range(n_boot)])
    return BootstrapResult(reference_components=h_ref, similarities=sims)


# ---------------------------------------------------------------------------
# masked (weighted) MU and cross-validated rank selection
# ---------------------------------------------------------------------------

@full_precision
def _masked_mu_update(x, mask, w, h):
    """Weighted multiplicative update (Frobenius objective on mask)."""
    mx = mask * x
    ht = h.T
    numerator = mx @ ht
    denominator = (mask * (w @ h)) @ ht
    denominator = jnp.where(denominator == 0, EPSILON, denominator)
    w = w * (numerator / denominator)

    wt = w.T
    numerator = wt @ mx
    denominator = wt @ (mask * (w @ h))
    denominator = jnp.where(denominator == 0, EPSILON, denominator)
    h = h * (numerator / denominator)
    return w, h


def _masked_error(x, mask, w, h):
    # Stopping statistic: Precision.HIGHEST reconstruction (the bf16
    # default flips near-threshold stopping decisions; see
    # models.mu.frobenius_error)
    wh = jnp.matmul(w, h, precision=jax.lax.Precision.HIGHEST)
    diff = mask * (x - wh)
    return jnp.sqrt(jnp.sum(diff * diff))


@functools.partial(
    jax.jit, static_argnames=("max_iter", "tol", "check_every")
)
def fit_mu_masked(
    x: jnp.ndarray,
    mask: jnp.ndarray,
    w0: jnp.ndarray,
    h0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
) -> MUState:
    """Masked MU-NMF: minimize ``||mask * (X - WH)||_F`` on device.

    Same loop structure and stopping rule as
    :func:`muscle_synergies_tpu.models.mu.fit_mu`, with every update and
    the convergence error restricted to observed (mask=1) entries.
    """
    error_at_init = _masked_error(x, mask, w0, h0)

    def chunk(state: MUState) -> MUState:
        steps = jnp.minimum(check_every, max_iter - state.n_iter)

        def body(_, wh):
            return _masked_mu_update(x, mask, *wh)

        w, h = jax.lax.fori_loop(0, steps, body, (state.w, state.h))
        n_iter = state.n_iter + steps
        if tol > 0:
            error = _masked_error(x, mask, w, h)
            converged = jnp.logical_and(
                (state.previous_error - error) / error_at_init < tol,
                n_iter % check_every == 0,
            )
            return MUState(w, h, n_iter, error, converged)
        return MUState(w, h, n_iter, state.previous_error, state.converged)

    def cond(state):
        return jnp.logical_and(state.n_iter < max_iter, ~state.converged)

    init = MUState(
        w=jnp.asarray(w0),
        h=jnp.asarray(h0),
        n_iter=jnp.zeros((), jnp.int32),
        previous_error=error_at_init,
        converged=jnp.zeros((), bool),
    )
    return jax.lax.while_loop(cond, chunk, init)


class CVResult(NamedTuple):
    """Cross-validated rank selection outcome.

    ``test_error``: ``(n_repeats, n_ranks)`` relative held-out
    reconstruction errors.  ``best_rank``: the rank minimizing the mean
    held-out error.
    """

    ranks: tuple
    test_error: np.ndarray
    best_rank: int

    @property
    def mean_test_error(self) -> np.ndarray:
        return self.test_error.mean(axis=0)


def cv_rank_selection(
    x,
    ranks: Sequence[int],
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    init: Optional[str] = None,
    max_iter: int = 500,
    tol: float = 1e-6,
    mesh=None,
) -> CVResult:
    """Wold-style CV: mask random entries, score their reconstruction.

    For every (repeat, rank) pair a masked MU fit runs; all pairs are
    batched into one vmapped solve (ranks zero-padded to the maximum).
    With ``mesh`` the (repeat, rank) grid axis shards over every mesh
    device (each masked fit is independent; duplicate-padded, exact).
    """
    x = jnp.asarray(np.asarray(x, dtype=float))
    n, l = x.shape
    k_max = max(ranks)
    rng = np.random.default_rng(seed)

    masks = (rng.random((n_repeats, n, l)) >= holdout_fraction).astype(x.dtype)

    xs, ms, w0s, h0s = [], [], [], []
    for r in range(n_repeats):
        x_obs = x * masks[r]
        for k in ranks:
            w0, h0 = initialize_nmf(x_obs, k, init=init, seed=seed + r)
            w0p, h0p = _pad_rank(w0, h0, k, k_max)
            xs.append(x)
            ms.append(jnp.asarray(masks[r]))
            w0s.append(w0p)
            h0s.append(h0p)

    (gx, gm, gw, gh), n_real, sharded = _shard_boot_axis(
        mesh, "cv_rank_selection",
        jnp.stack(xs), jnp.stack(ms), jnp.stack(w0s), jnp.stack(h0s),
    )
    fits = jax.vmap(
        lambda xi, mi, wi, hi: fit_mu_masked(
            xi, mi, wi, hi, max_iter=max_iter, tol=tol
        )
    )(gx, gm, gw, gh)
    if sharded:
        fits = jax.tree.map(lambda a: a[:n_real], fits)

    heldout = []
    x_np = np.asarray(x)
    denom = np.linalg.norm(x_np)
    ws, hs = np.asarray(fits.w), np.asarray(fits.h)
    for i in range(len(xs)):
        r, ki = divmod(i, len(ranks))
        test_mask = 1.0 - masks[r]
        err = test_mask * (x_np - ws[i] @ hs[i])
        heldout.append(np.linalg.norm(err) / denom)
    test_error = np.asarray(heldout).reshape(n_repeats, len(ranks))
    best_rank = int(tuple(ranks)[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(tuple(ranks), test_error, best_rank)


# ---------------------------------------------------------------------------
# time-varying (convolutive) stability and rank selection
# ---------------------------------------------------------------------------

@dataclass
class TimeVaryingBootstrapResult:
    """Per-synergy stability of a convolutive factorization.

    Attributes:
        reference_synergies: ``(K, D, L)`` unit-norm patterns of the
            full fit.
        similarities: ``(n_boot, K)`` matched, shift-tolerant cosine
            similarity of each reference synergy in each block-bootstrap
            refit.
    """

    reference_synergies: np.ndarray
    similarities: np.ndarray

    @property
    def mean(self) -> np.ndarray:
        return self.similarities.mean(axis=0)

    @property
    def std(self) -> np.ndarray:
        return self.similarities.std(axis=0)


def _best_shift(a: np.ndarray, b: np.ndarray, max_shift: int):
    """Best overlap-windowed cosine of two ``(D, L)`` patterns + its lag.

    Returns ``(similarity, shift)`` where ``shift >= 0`` means ``b``
    delayed by ``shift`` lags matches ``a`` (``a[shift + t] ~ b[t]``).
    """
    d = a.shape[0]
    best, best_sh = -1.0, 0
    for sh in range(-max_shift, max_shift + 1):
        if sh >= 0:
            aa, bb = a[sh:], b[: d - sh]
        else:
            aa, bb = a[: d + sh], b[-sh:]
        na, nb = np.linalg.norm(aa), np.linalg.norm(bb)
        if na == 0 or nb == 0:
            continue
        sim = float(np.sum(aa * bb) / (na * nb))
        if sim > best:
            best, best_sh = sim, sh
    return best, best_sh


def _shifted_cosine(a: np.ndarray, b: np.ndarray, max_shift: int) -> float:
    """Cosine of two ``(D, L)`` patterns at their best relative lag shift.

    The convolutive model has a time-shift indeterminacy (a synergy
    delayed by one lag with its activations advanced by one is the same
    reconstruction), so plain flattened cosine under-scores genuinely
    stable synergies; the overlap-windowed maximum removes that.
    """
    return _best_shift(a, b, max_shift)[0]


def _match_time_varying(
    s_ref: np.ndarray, s_boot: np.ndarray, max_shift: int
) -> np.ndarray:
    """Best-assignment shift-tolerant similarity per reference synergy."""
    from scipy.optimize import linear_sum_assignment

    k = s_ref.shape[0]
    sim = np.zeros((k, k))
    for i in range(k):
        for j in range(k):
            sim[i, j] = _shifted_cosine(s_ref[i], s_boot[j], max_shift)
    rows, cols = linear_sum_assignment(-sim)
    matched = np.zeros(k)
    matched[rows] = sim[rows, cols]
    return matched


def _block_bootstrap_indices(n, block_len, n_boot, rng) -> np.ndarray:
    """Moving-block bootstrap index matrix ``(n_boot, n)``.

    IID row resampling (the plain bootstrap above) destroys exactly
    the temporal structure the convolutive model factorizes; contiguous
    blocks of ``block_len >= n_lags`` samples keep every lag window
    intact except at the (rare) block seams.
    """
    n_blocks = -(-n // block_len)  # ceil
    starts = rng.integers(0, n - block_len + 1, size=(n_boot, n_blocks))
    offsets = np.arange(block_len)
    return (starts[:, :, None] + offsets).reshape(n_boot, -1)[:, :n]


def bootstrap_time_varying_synergies(
    x,
    n_synergies: int,
    n_lags: int,
    n_boot: int = 50,
    block_len: Optional[int] = None,
    seed: int = 0,
    max_iter: int = 300,
    tol: float = 1e-5,
    match_max_shift: Optional[int] = None,
    mesh=None,
    _resample_plan=None,
) -> TimeVaryingBootstrapResult:
    """Block-bootstrap the time axis and score synergy stability.

    The convolutive companion to :func:`bootstrap_synergies`: resamples
    are *moving blocks* (default ``block_len = 4 * n_lags``) so lag
    windows survive the resampling, all refits run as ONE batched
    device solve, and matching tolerates the model's time-shift
    indeterminacy (``match_max_shift`` lags each way, default
    ``n_lags // 2``).  With ``mesh`` the resample batch runs through
    :func:`~muscle_synergies_tpu.parallel.sharded_fit_cnmf` — resamples
    shard over ``data`` (duplicate-padded, exact), samples over
    ``time`` with lag-halo exchanges; an indivisible sample count or a
    halo wider than one time shard falls back locally with a warning.
    """
    from .cnmf import fit_cnmf, fit_cnmf_batch, init_cnmf, normalize_synergies

    x = jnp.asarray(np.asarray(x, dtype=float))
    n = x.shape[0]
    if block_len is None:
        block_len = min(max(4 * n_lags, 16), n)
    if not n_lags <= block_len <= n:
        raise ValueError(
            f"block_len must be in [n_lags={n_lags}, n_samples={n}], "
            f"got {block_len}"
        )
    if match_max_shift is None:
        match_max_shift = n_lags // 2

    c0, s0 = init_cnmf(np.asarray(x), n_synergies, n_lags, seed=seed)
    ref = fit_cnmf(x, jnp.asarray(c0), jnp.asarray(s0),
                   max_iter=max_iter, tol=tol)
    _, s_ref = normalize_synergies(ref.c, ref.s)
    s_ref = np.asarray(s_ref)

    if _resample_plan is None:
        rng = np.random.default_rng(seed)
        idx = _block_bootstrap_indices(n, block_len, n_boot, rng)
        row0 = 0
    else:
        # resume plumbing (models.resume): precomputed block-resample
        # rows plus the global row offset, so the batched init's
        # per-row ``seed + b`` seeding matches the unchunked run
        idx, row0 = _resample_plan
        n_boot = idx.shape[0]
    xb = x[jnp.asarray(idx)]  # (n_boot, N, L)
    c0b, s0b = init_cnmf(
        np.asarray(xb), n_synergies, n_lags, seed=seed + row0
    )
    c0b, s0b = jnp.asarray(c0b), jnp.asarray(s0b)

    if mesh is not None:
        from ..dataset import _usable_mesh

        mesh = _usable_mesh(mesh, "bootstrap_time_varying_synergies")
    n_time = mesh.shape.get("time", 1) if mesh is not None else 1
    mesh_divides = (
        mesh is not None
        and n % n_time == 0
        and n_lags - 1 <= n // n_time
    )
    if mesh is not None and not mesh_divides:
        import warnings

        warnings.warn(
            f"bootstrap_time_varying_synergies: sample count {n} must "
            f"divide over the mesh's {n_time}-way time axis with one "
            f"shard covering the lag halo ({n_lags - 1}); falling back "
            "to the local batched solver.",
            stacklevel=2,
        )
    if mesh_divides:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ..parallel.cnmf import sharded_fit_cnmf
        from ..parallel.mesh import DATA_AXIS, TIME_AXIS

        pad = (-n_boot) % mesh.shape[DATA_AXIS]
        if pad:
            xb = jnp.concatenate(
                [xb, jnp.repeat(xb[:1], pad, axis=0)], axis=0
            )
            c0b = jnp.concatenate(
                [c0b, jnp.repeat(c0b[:1], pad, axis=0)], axis=0
            )
            s0b = jnp.concatenate(
                [s0b, jnp.repeat(s0b[:1], pad, axis=0)], axis=0
            )
        xb = jax.device_put(
            xb, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        c0b = jax.device_put(
            c0b, NamedSharding(mesh, P(DATA_AXIS, TIME_AXIS, None))
        )
        s0b = jax.device_put(
            s0b, NamedSharding(mesh, P(DATA_AXIS, None, None, None))
        )
        states = sharded_fit_cnmf(
            xb, c0b, s0b, mesh, max_iter=max_iter, tol=tol
        )
        states = jax.tree.map(lambda a: a[:n_boot], states)
    else:
        states = fit_cnmf_batch(
            xb, c0b, s0b, max_iter=max_iter, tol=tol
        )
    _, sb = normalize_synergies(states.c, states.s)
    sb = np.asarray(sb)

    sims = np.stack([
        _match_time_varying(s_ref, sb[b], match_max_shift)
        for b in range(n_boot)
    ])
    return TimeVaryingBootstrapResult(
        reference_synergies=s_ref, similarities=sims
    )


@full_precision
def _masked_cnmf_update(x, mask, c, s):
    """Weighted convolutive MU: every projection sees ``mask * (·)``.

    The EM treatment of missing entries, exactly as
    :func:`_masked_mu_update` does for the flat model; mirrors
    :func:`muscle_synergies_tpu.models.cnmf.cnmf_update` otherwise
    (S per lag slice, then C as a ratio of look-ahead sums).
    """
    from .cnmf import _lag_stack, _shift_up

    n_lags = s.shape[1]
    mx = mask * x

    cs = _lag_stack(c, n_lags)  # (D, T, K)
    xhat = mask * jnp.einsum("dtk,kdl->tl", cs, s)
    num_s = jnp.einsum("dtk,tl->kdl", cs, mx)
    den_s = jnp.einsum("dtk,tl->kdl", cs, xhat)
    s = s * (num_s / jnp.where(den_s == 0, EPSILON, den_s))

    cs = _lag_stack(c, n_lags)
    xhat = mask * jnp.einsum("dtk,kdl->tl", cs, s)
    g_num = jnp.einsum("tl,kdl->dtk", mx, s)
    g_den = jnp.einsum("tl,kdl->dtk", xhat, s)
    num_c = sum(_shift_up(g_num[d], d) for d in range(n_lags))
    den_c = sum(_shift_up(g_den[d], d) for d in range(n_lags))
    c = c * (num_c / jnp.where(den_c == 0, EPSILON, den_c))
    return c, s


def _masked_cnmf_error(x, mask, c, s):
    from .cnmf import cnmf_reconstruct

    # Stopping statistic: Precision.HIGHEST (see _masked_error)
    rec = cnmf_reconstruct(c, s, precision=jax.lax.Precision.HIGHEST)
    diff = mask * (x - rec)
    return jnp.sqrt(jnp.sum(diff * diff))


@functools.partial(
    jax.jit, static_argnames=("max_iter", "tol", "check_every")
)
def fit_cnmf_masked(
    x: jnp.ndarray,
    mask: jnp.ndarray,
    c0: jnp.ndarray,
    s0: jnp.ndarray,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
):
    """Masked convolutive NMF: minimize ``||mask * (X - X̂)||_F``.

    Same loop structure and stopping rule as
    :func:`muscle_synergies_tpu.models.cnmf.fit_cnmf`, restricted to
    observed (mask=1) entries.
    """
    from .cnmf import CNMFState

    error_init = _masked_cnmf_error(x, mask, c0, s0)

    def cond(state):
        return (state.n_iter < max_iter) & ~state.converged

    def body(state):
        c, s = state.c, state.s
        for _ in range(check_every):
            c, s = _masked_cnmf_update(x, mask, c, s)
        error = _masked_cnmf_error(x, mask, c, s)
        improvement = (state.previous_error - error) / jnp.maximum(
            error_init, EPSILON
        )
        return CNMFState(
            c, s, state.n_iter + check_every, error, improvement < tol
        )

    init = CNMFState(
        c0.astype(x.dtype),
        s0.astype(x.dtype),
        jnp.asarray(0, jnp.int32),
        error_init,
        jnp.asarray(False),
    )
    return jax.lax.while_loop(cond, body, init)


def cv_time_varying_rank_selection(
    x,
    ranks: Sequence[int],
    n_lags: int,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 300,
    tol: float = 1e-5,
    mesh=None,
) -> CVResult:
    """Wold-style CV for the convolutive model's synergy count.

    Hold out random entries, fit :func:`fit_cnmf_masked` on the rest
    for every (repeat, rank) pair — one vmapped device solve, synergy
    counts zero-padded to the maximum (padded synergies and their
    activation columns start at zero, so every MU numerator touching
    them is identically zero and they stay zero) — and score each
    rank's held-out reconstruction error.  With ``mesh`` the
    (repeat, rank) grid axis shards over every mesh device.
    """
    from .cnmf import cnmf_reconstruct, init_cnmf

    x = jnp.asarray(np.asarray(x, dtype=float))
    n, l = x.shape
    k_max = max(ranks)
    rng = np.random.default_rng(seed)

    masks = (rng.random((n_repeats, n, l)) >= holdout_fraction).astype(x.dtype)

    xs, ms, c0s, s0s = [], [], [], []
    for r in range(n_repeats):
        x_obs = np.asarray(x * masks[r])
        for k in ranks:
            c0, s0 = init_cnmf(x_obs, k, n_lags, seed=seed + r)
            c0p = np.concatenate(
                [c0, np.zeros((n, k_max - k), c0.dtype)], axis=1
            )
            s0p = np.concatenate(
                [s0, np.zeros((k_max - k, n_lags, l), s0.dtype)], axis=0
            )
            xs.append(x)
            ms.append(jnp.asarray(masks[r]))
            c0s.append(jnp.asarray(c0p))
            s0s.append(jnp.asarray(s0p))

    (gx, gm, gc, gs), n_real, sharded = _shard_boot_axis(
        mesh, "cv_time_varying_rank_selection",
        jnp.stack(xs), jnp.stack(ms), jnp.stack(c0s), jnp.stack(s0s),
    )
    fits = jax.vmap(
        lambda xi, mi, ci, si: fit_cnmf_masked(
            xi, mi, ci, si, max_iter=max_iter, tol=tol
        )
    )(gx, gm, gc, gs)
    if sharded:
        fits = jax.tree.map(lambda a: a[:n_real], fits)

    heldout = []
    x_np = np.asarray(x)
    denom = np.linalg.norm(x_np)
    cs_fit, ss_fit = np.asarray(fits.c), np.asarray(fits.s)
    rec = np.asarray(
        jax.vmap(cnmf_reconstruct)(jnp.asarray(cs_fit), jnp.asarray(ss_fit))
    )
    for i in range(len(xs)):
        r, _ = divmod(i, len(ranks))
        err = (1.0 - masks[r]) * (x_np - rec[i])
        heldout.append(np.linalg.norm(err) / denom)
    test_error = np.asarray(heldout).reshape(n_repeats, len(ranks))
    best_rank = int(tuple(ranks)[int(np.argmin(test_error.mean(axis=0)))])
    return CVResult(tuple(ranks), test_error, best_rank)


# ---------------------------------------------------------------------------
# space-by-time (NM3F) stability and module-count selection
# ---------------------------------------------------------------------------

def _shard_boot_axis(mesh, caller: str, *arrays):
    """Shard each array's leading (resample) axis over every mesh device.

    The meshed path of the vmapped whole-fit bootstraps: each resample
    is an independent problem, so the boot axis shards over BOTH mesh
    axes together (no collective to place) with duplicate padding to
    divisibility — exact, the padded fits are dropped.

    Returns ``(arrays, n_real, sharded)``; ``sharded`` is False when
    the mesh is unusable (warned) or ``None``, in which case the
    arrays come back untouched.
    """
    if mesh is not None:
        from ..dataset import _usable_mesh

        mesh = _usable_mesh(mesh, caller)
    n_real = arrays[0].shape[0]
    if mesh is None:
        return arrays, n_real, False

    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.mesh import DATA_AXIS, TIME_AXIS

    n_dev = mesh.shape[DATA_AXIS] * mesh.shape[TIME_AXIS]
    pad = (-n_real) % n_dev
    if pad:
        arrays = tuple(
            jnp.concatenate(
                [arr, jnp.repeat(arr[:1], pad, axis=0)], axis=0
            )
            for arr in arrays
        )
    arrays = tuple(
        jax.device_put(
            arr,
            NamedSharding(
                mesh, P((DATA_AXIS, TIME_AXIS), *([None] * (arr.ndim - 1)))
            ),
        )
        for arr in arrays
    )
    return arrays, n_real, True


def bootstrap_space_by_time(
    xs,
    n_temporal: int,
    n_spatial: int,
    n_boot: int = 50,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
):
    """Trial-axis bootstrap stability of the shared NM3F modules.

    Trials are exchangeable under the space-by-time model (the shared
    modules couple them; their order carries no structure), so the
    plain iid bootstrap that would break the convolutive model is the
    right resampling here: refit on ``n_boot`` resampled TRIAL sets —
    as one vmapped batch over resamples — and score each reference
    module's best-assignment cosine similarity across refits.

    With ``mesh`` the RESAMPLE axis shards over every device of the
    mesh (both axes together — each refit is a whole independent NM3F
    problem, so unlike the solvers there is no collective to place and
    the boot axis is the only scale axis; duplicate-padded, exact).

    Returns:
        ``(temporal BootstrapResult, spatial BootstrapResult)`` — the
        reference components are the unit-norm ``(P, T)`` temporal and
        ``(Q, L)`` spatial modules of the full fit.
    """
    from .nm3f import fit_nm3f, init_nm3f, normalize_modules

    xs = np.asarray(xs, dtype=float)
    b = xs.shape[0]

    w0, a0, s0 = init_nm3f(xs, n_temporal, n_spatial, seed=seed)
    ref = fit_nm3f(
        jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
        jnp.asarray(s0), max_iter=max_iter, tol=tol,
    )
    w_ref, _, s_ref = normalize_modules(ref.w, ref.a, ref.s)
    w_ref = np.asarray(w_ref).T  # (P, T): components as rows
    s_ref = np.asarray(s_ref)  # (Q, L)

    if _resample_plan is None:
        rng = np.random.default_rng(seed)
        idx = rng.integers(0, b, size=(n_boot, b))
        row0 = 0
    else:
        # resume plumbing (models.resume): precomputed trial-resample
        # rows plus the global row offset for the per-row init seeds
        idx, row0 = _resample_plan
        n_boot = idx.shape[0]
    xb = jnp.asarray(xs)[jnp.asarray(idx)]  # (n_boot, B, T, L)
    inits = [
        init_nm3f(
            xs[idx[r]], n_temporal, n_spatial, seed=seed + 1 + row0 + r
        )
        for r in range(n_boot)
    ]
    w0b = jnp.asarray(np.stack([i[0] for i in inits]))
    a0b = jnp.asarray(np.stack([i[1] for i in inits]))
    s0b = jnp.asarray(np.stack([i[2] for i in inits]))

    (xb, w0b, a0b, s0b), n_real, sharded = _shard_boot_axis(
        mesh, "bootstrap_space_by_time", xb, w0b, a0b, s0b
    )
    states = jax.vmap(
        lambda x, w, a, s: fit_nm3f(x, w, a, s, max_iter=max_iter, tol=tol)
    )(xb, w0b, a0b, s0b)
    if sharded:
        states = jax.tree.map(lambda a: a[:n_real], states)
    wn, _, sn = jax.vmap(normalize_modules)(states.w, states.a, states.s)
    wn = np.swapaxes(np.asarray(wn), 1, 2)  # (n_boot, P, T)
    sn = np.asarray(sn)

    sims_w = np.stack(
        [_match_components(w_ref, wn[r]) for r in range(n_boot)]
    )
    sims_s = np.stack(
        [_match_components(s_ref, sn[r]) for r in range(n_boot)]
    )
    return (
        BootstrapResult(reference_components=w_ref, similarities=sims_w),
        BootstrapResult(reference_components=s_ref, similarities=sims_s),
    )


@full_precision
def _masked_nm3f_update(xs, mask, w, a, s, update_w=True, update_s=True):
    """Weighted trilinear MU: every projection of X / X̂ sees the mask.

    Mirrors :func:`muscle_synergies_tpu.models.nm3f.nm3f_update`
    (A-then-W-then-S order) with ``mask * X`` and ``mask * X̂`` in
    every numerator/denominator — the EM treatment of missing entries,
    exactly as :func:`_masked_mu_update` does for the flat model.
    ``update_w`` / ``update_s`` freeze a module set (the shared-factor
    tMod/sMod specializations hold one side at identity).
    """
    from .nm3f import nm3f_reconstruct

    mx = mask * xs
    mrec = mask * nm3f_reconstruct(w, a, s)
    num_a = jnp.einsum("tp,btl,ql->bpq", w, mx, s)
    den_a = jnp.einsum("tp,btl,ql->bpq", w, mrec, s)
    a = a * (num_a / jnp.where(den_a == 0, EPSILON, den_a))

    if update_w:
        mrec = mask * nm3f_reconstruct(w, a, s)
        num_w = jnp.einsum("btl,ql,bpq->tp", mx, s, a)
        den_w = jnp.einsum("btl,ql,bpq->tp", mrec, s, a)
        w = w * (num_w / jnp.where(den_w == 0, EPSILON, den_w))

    if update_s:
        mrec = mask * nm3f_reconstruct(w, a, s)
        num_s = jnp.einsum("bpq,tp,btl->ql", a, w, mx)
        den_s = jnp.einsum("bpq,tp,btl->ql", a, w, mrec)
        s = s * (num_s / jnp.where(den_s == 0, EPSILON, den_s))
    return w, a, s


def _masked_nm3f_error(xs, mask, w, a, s):
    from .nm3f import nm3f_reconstruct

    # Stopping statistic: Precision.HIGHEST (see _masked_error)
    rec = nm3f_reconstruct(w, a, s, precision=jax.lax.Precision.HIGHEST)
    diff = mask * (xs - rec)
    return jnp.sqrt(jnp.sum(diff * diff))


@functools.partial(
    jax.jit,
    static_argnames=(
        "max_iter", "tol", "check_every", "update_w", "update_s",
    ),
)
def fit_nm3f_masked(
    xs: jnp.ndarray,
    mask: jnp.ndarray,
    w0: jnp.ndarray,
    a0: jnp.ndarray,
    s0: jnp.ndarray,
    max_iter: int = 400,
    tol: float = 1e-6,
    check_every: int = 10,
    update_w: bool = True,
    update_s: bool = True,
):
    """Masked NM3F: minimize ``||mask * (X - W A S)||_F`` on device.

    Same loop structure and stopping rule as
    :func:`muscle_synergies_tpu.models.nm3f.fit_nm3f`, restricted to
    observed (mask=1) entries.  Note the masked updates rebuild the
    full reconstruction per half-step (no Gram shortcut exists under a
    mask), like :func:`fit_mu_masked`.  ``update_w`` / ``update_s``
    freeze a module set (the tMod/sMod shared-factor specializations).
    """
    from .nm3f import NM3FState

    error_init = _masked_nm3f_error(xs, mask, w0, a0, s0)

    def cond(state):
        return (state.n_iter < max_iter) & ~state.converged

    def body(state):
        steps = jnp.minimum(check_every, max_iter - state.n_iter)

        def one(_, was):
            return _masked_nm3f_update(
                xs, mask, *was, update_w=update_w, update_s=update_s
            )

        w, a, s = jax.lax.fori_loop(
            0, steps, one, (state.w, state.a, state.s)
        )
        n_iter = state.n_iter + steps
        error = _masked_nm3f_error(xs, mask, w, a, s)
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


class SpaceByTimeCVResult(NamedTuple):
    """Held-out module-count selection outcome.

    ``test_error``: ``(n_repeats, n_pairs)`` relative held-out errors,
    one column per ``(P, Q)`` candidate.  ``best``: the pair minimizing
    the mean held-out error.
    """

    pairs: tuple
    test_error: np.ndarray
    best: tuple

    @property
    def mean_test_error(self) -> np.ndarray:
        return self.test_error.mean(axis=0)


def cv_space_by_time_selection(
    xs,
    pairs: Sequence,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
) -> SpaceByTimeCVResult:
    """Wold-style CV over ``(n_temporal, n_spatial)`` candidates.

    Hold out random entries across the whole trial stack, fit
    :func:`fit_nm3f_masked` on the rest for every (repeat, pair) — ONE
    vmapped device solve with both module counts zero-padded to the
    grid maxima (padded modules and their coefficient rows/columns
    start at zero, so every MU numerator touching them is identically
    zero and they stay zero) — and score each candidate's held-out
    reconstruction error.  With ``mesh`` the (repeat, pair) grid axis
    shards over every mesh device.
    """
    from .nm3f import init_nm3f

    xs = jnp.asarray(np.asarray(xs, dtype=float))
    b, t, l = xs.shape
    pairs = tuple((int(p), int(q)) for p, q in pairs)
    p_max = max(p for p, _ in pairs)
    q_max = max(q for _, q in pairs)
    rng = np.random.default_rng(seed)

    masks = (
        rng.random((n_repeats, b, t, l)) >= holdout_fraction
    ).astype(xs.dtype)

    xs_list, ms, w0s, a0s, s0s = [], [], [], [], []
    for r in range(n_repeats):
        x_obs = np.asarray(xs * masks[r])
        for p, q in pairs:
            w0, a0, s0 = init_nm3f(x_obs, p, q, seed=seed + r)
            w0p = np.zeros((t, p_max), w0.dtype)
            w0p[:, :p] = w0
            a0p = np.zeros((b, p_max, q_max), a0.dtype)
            a0p[:, :p, :q] = a0
            s0p = np.zeros((q_max, l), s0.dtype)
            s0p[:q] = s0
            xs_list.append(xs)
            ms.append(jnp.asarray(masks[r]))
            w0s.append(jnp.asarray(w0p))
            a0s.append(jnp.asarray(a0p))
            s0s.append(jnp.asarray(s0p))

    (gx, gm, gw, ga, gs), n_real, sharded = _shard_boot_axis(
        mesh, "cv_space_by_time_selection",
        jnp.stack(xs_list), jnp.stack(ms), jnp.stack(w0s),
        jnp.stack(a0s), jnp.stack(s0s),
    )
    fits = jax.vmap(
        lambda xi, mi, wi, ai, si: fit_nm3f_masked(
            xi, mi, wi, ai, si, max_iter=max_iter, tol=tol
        )
    )(gx, gm, gw, ga, gs)
    if sharded:
        fits = jax.tree.map(lambda a: a[:n_real], fits)

    from .nm3f import nm3f_reconstruct

    rec = np.asarray(
        jax.vmap(nm3f_reconstruct)(fits.w, fits.a, fits.s)
    )
    x_np = np.asarray(xs)
    denom = np.linalg.norm(x_np)
    heldout = []
    for i in range(len(xs_list)):
        r = i // len(pairs)
        err = (1.0 - masks[r]) * (x_np - rec[i])
        heldout.append(np.linalg.norm(err) / denom)
    test_error = np.asarray(heldout).reshape(n_repeats, len(pairs))
    best = pairs[int(np.argmin(test_error.mean(axis=0)))]
    return SpaceByTimeCVResult(pairs, test_error, best)


# ---------------------------------------------------------------------------
# cross-set synergy comparison
# ---------------------------------------------------------------------------


class SynergyMatch(NamedTuple):
    """Best-assignment pairing between two synergy sets.

    Attributes:
        pairs: matched ``(i, j)`` index pairs — component ``i`` of set
            A paired with component ``j`` of set B; ``min(k_a, k_b)``
            of them, ordered by ``i``.
        similarities: cosine similarity of each pair (shift-tolerant
            for time-varying sets), aligned with ``pairs``.
        similarity_matrix: the full ``(k_a, k_b)`` similarity matrix
            the assignment optimized over.
    """

    pairs: list
    similarities: np.ndarray
    similarity_matrix: np.ndarray

    @property
    def mean(self) -> float:
        """Mean matched similarity — the set-level agreement score."""
        return float(self.similarities.mean()) if len(self.pairs) else 0.0


def match_synergies(a, b, max_shift: Optional[int] = None) -> SynergyMatch:
    """Match two synergy sets and score their similarity.

    The standard cross-subject / cross-condition / cross-day
    comparison of the synergy literature (e.g. d'Avella et al. 2003's
    cosine-matched synergies; the same matching the bootstrap
    stability layer uses internally): find the one-to-one assignment
    between the two sets that maximizes total cosine similarity
    (Hungarian algorithm; rectangular sets pair ``min(k_a, k_b)``
    components and leave the surplus unmatched).

    Args:
        a / b: synergy sets — ``(k, L)`` spatial components (arrays or
            DataFrames, e.g. ``SynergyRunResult.components[rank]`` or
            NM3F spatial modules), or ``(K, D, L)`` time-varying
            synergy stacks (e.g. ``CNMFModel.synergies_``).  Both must
            have the same kind and trailing shape.
        max_shift: for time-varying sets only — the lag tolerance of
            the shift-invariant cosine (defaults to ``D // 2``, the
            bootstrap layer's rule; the convolutive model's time-shift
            indeterminacy makes plain cosine under-score genuinely
            identical synergies).

    Returns:
        :class:`SynergyMatch`; ``.mean`` is the set-level agreement.
    """
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if a.ndim != b.ndim or a.ndim not in (2, 3):
        raise ValueError(
            "expected two (k, L) spatial sets or two (K, D, L) "
            f"time-varying sets, got shapes {a.shape} and {b.shape}"
        )
    if a.shape[1:] != b.shape[1:]:
        raise ValueError(
            f"synergy shapes differ: {a.shape[1:]} vs {b.shape[1:]}"
        )
    if a.ndim == 2:
        if max_shift is not None:
            raise ValueError(
                "max_shift applies to (K, D, L) time-varying sets only"
            )

        def normalize(h):
            norm = np.linalg.norm(h, axis=1, keepdims=True)
            return h / np.where(norm == 0, 1.0, norm)

        sim = normalize(a) @ normalize(b).T
    else:
        if max_shift is None:
            max_shift = a.shape[1] // 2
        sim = np.zeros((a.shape[0], b.shape[0]))
        for i in range(a.shape[0]):
            for j in range(b.shape[0]):
                sim[i, j] = _shifted_cosine(a[i], b[j], max_shift)

    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(-sim)
    order = np.argsort(rows)
    pairs = [(int(rows[t]), int(cols[t])) for t in order]
    return SynergyMatch(
        pairs=pairs,
        similarities=sim[rows[order], cols[order]],
        similarity_matrix=sim,
    )


def _cv_shared_factor_selection(
    xs,
    candidates,
    temporal: bool,
    holdout_fraction: float,
    n_repeats: int,
    seed: int,
    max_iter: int,
    tol: float,
    mesh=None,
) -> CVResult:
    """Wold-style CV core shared by the tMod/sMod selectors.

    One vmapped :func:`fit_nm3f_masked` over the (repeat, candidate)
    grid with the free side zero-padded to the grid maximum (padded
    modules start at zero, so every masked MU numerator touching them
    is identically zero and they stay zero) and the other side frozen
    at identity.  With ``mesh`` the grid axis shards over every mesh
    device.
    """
    xs = jnp.asarray(np.asarray(xs, dtype=float))
    b, t, l = xs.shape
    candidates = tuple(int(k) for k in candidates)
    bound = t if temporal else l
    for k in candidates:
        if not 1 <= k <= bound:
            raise ValueError(
                f"candidate module count {k} outside [1, {bound}]"
            )
    k_max = max(candidates)
    rng = np.random.default_rng(seed)
    masks = (
        rng.random((n_repeats, b, t, l)) >= holdout_fraction
    ).astype(xs.dtype)
    eye = np.eye(l if temporal else t)

    xs_list, ms, w0s, a0s, s0s = [], [], [], [], []
    for r in range(n_repeats):
        x_obs = np.asarray(xs * masks[r])
        for k in candidates:
            c = (max(x_obs.mean(), 0.0) / k) ** 0.5 if x_obs.size else 1.0
            if temporal:
                w0 = np.zeros((t, k_max))
                w0[:, :k] = rng.uniform(0, 2 * c, (t, k))
                a0 = np.zeros((b, k_max, l))
                a0[:, :k, :] = rng.uniform(0, 2 * c, (b, k, l))
                s0 = eye
            else:
                w0 = eye
                a0 = np.zeros((b, t, k_max))
                a0[:, :, :k] = rng.uniform(0, 2 * c, (b, t, k))
                s0 = np.zeros((k_max, l))
                s0[:k] = rng.uniform(0, 2 * c, (k, l))
            xs_list.append(xs)
            ms.append(jnp.asarray(masks[r]))
            w0s.append(jnp.asarray(w0))
            a0s.append(jnp.asarray(a0))
            s0s.append(jnp.asarray(s0))

    caller = (
        "cv_temporal_selection" if temporal else "cv_shared_spatial_selection"
    )
    (gx, gm, gw, ga, gs), n_real, sharded = _shard_boot_axis(
        mesh, caller,
        jnp.stack(xs_list), jnp.stack(ms), jnp.stack(w0s),
        jnp.stack(a0s), jnp.stack(s0s),
    )
    fits = jax.vmap(
        lambda xi, mi, wi, ai, si: fit_nm3f_masked(
            xi, mi, wi, ai, si, max_iter=max_iter, tol=tol,
            update_w=temporal, update_s=not temporal,
        )
    )(gx, gm, gw, ga, gs)
    if sharded:
        fits = jax.tree.map(lambda a: a[:n_real], fits)

    from .nm3f import nm3f_reconstruct

    rec = np.asarray(jax.vmap(nm3f_reconstruct)(fits.w, fits.a, fits.s))
    x_np = np.asarray(xs)
    denom = np.linalg.norm(x_np)
    heldout = []
    for i in range(len(xs_list)):
        r = i // len(candidates)
        err = (1.0 - masks[r]) * (x_np - rec[i])
        heldout.append(np.linalg.norm(err) / denom)
    test_error = np.asarray(heldout).reshape(n_repeats, len(candidates))
    best = candidates[int(np.argmin(test_error.mean(axis=0)))]
    return CVResult(candidates, test_error, best)


def cv_temporal_selection(
    xs,
    candidates: Sequence,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
) -> CVResult:
    """Held-out module-count selection for the shared-temporal model.

    The tMod counterpart of :func:`cv_space_by_time_selection`:
    random entries are held out across the whole stack, the masked
    trilinear fit runs with the spatial side FROZEN at identity
    (exactly :func:`~muscle_synergies_tpu.models.nm3f.find_temporal_synergies`'s
    model), and each candidate ``P`` is scored on held-out
    reconstruction error.  ``best_rank`` is the selected module count.
    """
    return _cv_shared_factor_selection(
        xs, candidates, True, holdout_fraction, n_repeats, seed,
        max_iter, tol, mesh=mesh,
    )


def cv_shared_spatial_selection(
    xs,
    candidates: Sequence,
    holdout_fraction: float = 0.1,
    n_repeats: int = 5,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
) -> CVResult:
    """Held-out module-count selection for the shared-spatial model.

    The sMod counterpart of :func:`cv_temporal_selection` — temporal
    side frozen at identity, candidates are spatial module counts
    ``Q``.
    """
    return _cv_shared_factor_selection(
        xs, candidates, False, holdout_fraction, n_repeats, seed,
        max_iter, tol, mesh=mesh,
    )


def _bootstrap_shared_factor(
    xs, k: int, temporal: bool, n_boot: int, seed: int,
    max_iter: int, tol: float, mesh=None, _resample_plan=None,
) -> BootstrapResult:
    """Trial-axis bootstrap core shared by the tMod/sMod wrappers.

    Same resampling argument as :func:`bootstrap_space_by_time`
    (trials are exchangeable under shared modules); fits run with one
    side frozen at identity, vmapped over resamples (the resample axis
    shards over every mesh device with ``mesh``, exactly as there).
    """
    xs = np.asarray(xs, dtype=float)
    b, t, l = xs.shape
    bound = t if temporal else l
    if not 1 <= k <= bound:
        raise ValueError(f"module count {k} outside [1, {bound}]")
    eye = np.eye(l if temporal else t)
    rng = np.random.default_rng(seed)

    def random_init(x_sub, r):
        c = (max(x_sub.mean(), 0.0) / k) ** 0.5 if x_sub.size else 1.0
        local = np.random.default_rng(seed + 1 + r)
        if temporal:
            w0 = local.uniform(0, 2 * c, (t, k))
            a0 = local.uniform(0, 2 * c, (b, k, l))
            return w0, a0, eye
        a0 = local.uniform(0, 2 * c, (b, t, k))
        s0 = local.uniform(0, 2 * c, (k, l))
        return eye, a0, s0

    from .nm3f import fit_nm3f

    def normalize_free(w, a, s):
        if temporal:
            wn = jnp.sqrt(jnp.sum(w * w, axis=0))
            return (w / jnp.where(wn == 0, 1.0, wn)[None, :]).T  # (k, T)
        sn = jnp.sqrt(jnp.sum(s * s, axis=1))
        return s / jnp.where(sn == 0, 1.0, sn)[:, None]  # (k, L)

    # full fit = reference modules
    w0, a0, s0 = random_init(xs, -1)
    ref = fit_nm3f(
        jnp.asarray(xs), jnp.asarray(w0), jnp.asarray(a0),
        jnp.asarray(s0), max_iter=max_iter, tol=tol,
        update_w=temporal, update_s=not temporal,
    )
    ref_mods = np.asarray(normalize_free(ref.w, ref.a, ref.s))

    if _resample_plan is None:
        idx = rng.integers(0, b, size=(n_boot, b))
        row0 = 0
    else:
        # resume plumbing (models.resume): precomputed rows + offset
        idx, row0 = _resample_plan
        n_boot = idx.shape[0]
    xb = jnp.asarray(xs)[jnp.asarray(idx)]
    inits = [random_init(xs[idx[r]], row0 + r) for r in range(n_boot)]
    w0b = jnp.asarray(np.stack([i[0] for i in inits]))
    a0b = jnp.asarray(np.stack([i[1] for i in inits]))
    s0b = jnp.asarray(np.stack([i[2] for i in inits]))
    caller = (
        "bootstrap_temporal_synergies"
        if temporal
        else "bootstrap_shared_spatial_synergies"
    )
    (xb, w0b, a0b, s0b), n_real, sharded = _shard_boot_axis(
        mesh, caller, xb, w0b, a0b, s0b
    )
    states = jax.vmap(
        lambda x, w, a, s: fit_nm3f(
            x, w, a, s, max_iter=max_iter, tol=tol,
            update_w=temporal, update_s=not temporal,
        )
    )(xb, w0b, a0b, s0b)
    if sharded:
        states = jax.tree.map(lambda a: a[:n_real], states)
    mods = np.asarray(
        jax.vmap(normalize_free)(states.w, states.a, states.s)
    )
    sims = np.stack(
        [_match_components(ref_mods, mods[r]) for r in range(n_boot)]
    )
    return BootstrapResult(reference_components=ref_mods, similarities=sims)


def bootstrap_temporal_synergies(
    xs,
    n_temporal: int,
    n_boot: int = 50,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
) -> BootstrapResult:
    """Trial-axis bootstrap stability of the shared-temporal model.

    The tMod counterpart of :func:`bootstrap_space_by_time` (spatial
    side frozen at identity, exactly
    :func:`~muscle_synergies_tpu.models.nm3f.find_temporal_synergies`'s
    model); reference components are the unit-norm ``(P, T)`` temporal
    modules of the full fit.
    """
    return _bootstrap_shared_factor(
        xs, n_temporal, True, n_boot, seed, max_iter, tol, mesh=mesh,
        _resample_plan=_resample_plan,
    )


def bootstrap_shared_spatial_synergies(
    xs,
    n_spatial: int,
    n_boot: int = 50,
    seed: int = 0,
    max_iter: int = 400,
    tol: float = 1e-6,
    mesh=None,
    _resample_plan=None,
) -> BootstrapResult:
    """Trial-axis bootstrap stability of the shared-spatial model.

    The sMod counterpart of :func:`bootstrap_temporal_synergies` —
    temporal side frozen at identity; reference components are the
    unit-norm ``(Q, L)`` spatial modules of the full fit.
    """
    return _bootstrap_shared_factor(
        xs, n_spatial, False, n_boot, seed, max_iter, tol, mesh=mesh,
        _resample_plan=_resample_plan,
    )


# ---------------------------------------------------------------------------
# N-set synergy clustering (group-level common synergies)
# ---------------------------------------------------------------------------

class SynergyClusters(NamedTuple):
    """Group-level clustering of synergy sets from many subjects/conditions.

    Attributes:
        labels: one int array per input set — the cluster id (0-based)
            of each of that set's components.
        consensus: ``(n_clusters, L)`` or ``(n_clusters, D, L)``
            unit-norm cluster-mean synergies (time-varying members are
            lag-aligned to the cluster medoid before averaging).
        membership: ``(n_clusters, n_sets)`` int counts — how many of
            set ``j``'s components landed in cluster ``i``.
        similarity_matrix: the pooled ``(total, total)`` cosine
            similarity matrix the clustering ran on (shift-tolerant
            for time-varying sets).
        set_index: ``(total,)`` — which input set each pooled row
            (row of ``similarity_matrix``) came from.
    """

    labels: list
    consensus: np.ndarray
    membership: np.ndarray
    similarity_matrix: np.ndarray
    set_index: np.ndarray

    @property
    def n_clusters(self) -> int:
        return self.membership.shape[0]

    @property
    def coverage(self) -> np.ndarray:
        """Fraction of input sets represented in each cluster."""
        return (self.membership > 0).mean(axis=1)

    @property
    def shared(self) -> np.ndarray:
        """Indices of clusters with a member from *every* input set."""
        return np.flatnonzero((self.membership > 0).all(axis=1))


def _shift_pattern(p: np.ndarray, sh: int) -> np.ndarray:
    """Delay a ``(D, L)`` pattern by ``sh`` lags with zero fill."""
    out = np.zeros_like(p)
    d = p.shape[0]
    if sh >= 0:
        out[sh:] = p[: d - sh]
    else:
        out[: d + sh] = p[-sh:]
    return out


def cluster_synergies(
    sets,
    n_clusters: Optional[int] = None,
    max_shift: Optional[int] = None,
) -> SynergyClusters:
    """Cluster synergy sets from many subjects/conditions at once.

    The N-set generalization of :func:`match_synergies`, and the
    standard group-level analysis of the synergy literature (e.g.
    Cheung et al. 2005's shared-vs-specific synergies;
    Torres-Oviedo & Ting 2007's hierarchical clustering of
    cosine-similar muscle weightings): pool every component from every
    set, run average-linkage hierarchical clustering on cosine
    distance, and report which clusters are *shared* across all sets
    (``.shared`` / ``.coverage``), which are subject-specific, and the
    unit-norm consensus synergy of each cluster.

    Beyond-reference capability: the reference compares synergy sets
    by eye (notebook plots only).

    Args:
        sets: sequence (>= 2) of synergy sets — all ``(k_i, L)``
            spatial components (arrays or DataFrames), or all
            ``(K_i, D, L)`` time-varying stacks with equal ``(D, L)``.
        n_clusters: number of clusters to cut the dendrogram at.
            Defaults to the (rounded) mean set size — the expected
            number of distinct synergies when the sets mostly share
            them.  Hierarchical cutting can produce fewer non-empty
            clusters; the result reports the realized count.
        max_shift: time-varying sets only — lag tolerance of the
            shift-invariant cosine (defaults to ``D // 2``, the
            bootstrap layer's rule).

    Returns:
        :class:`SynergyClusters`.
    """
    arrays = [np.asarray(s, dtype=float) for s in sets]
    if len(arrays) < 2:
        raise ValueError("need at least two synergy sets to cluster")
    ndim = arrays[0].ndim
    if ndim not in (2, 3) or any(a.ndim != ndim for a in arrays):
        raise ValueError(
            "expected all (k, L) spatial sets or all (K, D, L) "
            f"time-varying sets, got shapes {[a.shape for a in arrays]}"
        )
    trailing = arrays[0].shape[1:]
    if any(a.shape[1:] != trailing for a in arrays):
        raise ValueError(
            f"synergy shapes differ: {[a.shape[1:] for a in arrays]}"
        )
    if ndim == 2 and max_shift is not None:
        raise ValueError(
            "max_shift applies to (K, D, L) time-varying sets only"
        )

    pooled = np.concatenate(arrays, axis=0)
    set_index = np.concatenate(
        [np.full(a.shape[0], j) for j, a in enumerate(arrays)]
    )
    total = pooled.shape[0]
    if n_clusters is None:
        n_clusters = max(1, round(np.mean([a.shape[0] for a in arrays])))
    n_clusters = int(n_clusters)
    if not 1 <= n_clusters <= total:
        raise ValueError(
            f"n_clusters={n_clusters} out of range for {total} pooled "
            "components"
        )

    if ndim == 2:
        norms = np.linalg.norm(pooled, axis=1, keepdims=True)
        unit = pooled / np.where(norms == 0, 1.0, norms)
        sim = np.clip(unit @ unit.T, -1.0, 1.0)
    else:
        if max_shift is None:
            max_shift = trailing[0] // 2
        sim = np.eye(total)
        for i in range(total):
            for j in range(i + 1, total):
                sim[i, j] = sim[j, i] = _shifted_cosine(
                    pooled[i], pooled[j], max_shift
                )

    from scipy.cluster.hierarchy import fcluster, linkage
    from scipy.spatial.distance import squareform

    dist = np.maximum(1.0 - sim, 0.0)
    np.fill_diagonal(dist, 0.0)
    raw = fcluster(
        linkage(squareform(dist, checks=False), method="average"),
        t=n_clusters,
        criterion="maxclust",
    )
    # relabel 0-based in order of first appearance (fcluster ids are
    # arbitrary), so labels are deterministic in the pooled order
    remap: dict = {}
    labels_flat = np.array([remap.setdefault(r, len(remap)) for r in raw])
    n_real = len(remap)

    n_sets = len(arrays)
    membership = np.zeros((n_real, n_sets), dtype=int)
    np.add.at(membership, (labels_flat, set_index), 1)

    consensus = np.zeros((n_real,) + trailing)
    for c in range(n_real):
        members = np.flatnonzero(labels_flat == c)
        if ndim == 2:
            mean = unit[members].mean(axis=0)
        else:
            # lag-align members to the cluster medoid (the member most
            # similar to the rest) before averaging, else the model's
            # time-shift indeterminacy smears the consensus
            block = sim[np.ix_(members, members)]
            medoid = pooled[members[int(np.argmax(block.sum(axis=1)))]]
            aligned = []
            for m in members:
                _, sh = _best_shift(medoid, pooled[m], max_shift)
                shifted = _shift_pattern(pooled[m], sh)
                norm = np.linalg.norm(shifted)
                aligned.append(shifted / (norm if norm else 1.0))
            mean = np.mean(aligned, axis=0)
        norm = np.linalg.norm(mean)
        consensus[c] = mean / (norm if norm else 1.0)

    sizes = [a.shape[0] for a in arrays]
    splits = np.cumsum(sizes)[:-1]
    return SynergyClusters(
        labels=[lab for lab in np.split(labels_flat, splits)],
        consensus=consensus,
        membership=membership,
        similarity_matrix=sim,
        set_index=set_index,
    )
