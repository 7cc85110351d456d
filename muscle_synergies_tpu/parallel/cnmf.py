"""Sequence-parallel convolutive NMF over a ``(data, time)`` mesh.

Extends the mesh-sharded solver family (SURVEY §5 long-context row) to
the time-varying synergy model of :mod:`muscle_synergies_tpu.models.cnmf`.
The convolution couples neighboring time shards only through ``D - 1``
rows (the lag depth), so the sharding is a classic *halo exchange*:

- the lag stack ``Cs[d, t] = C[t-d]`` needs the left neighbor's last
  ``D-1`` activation rows (:func:`edge_shift` ``ppermute``, zero-filled
  at the global edge — exactly the causal zero padding the local
  model defines);
- the S update's numerators/denominators are global time reductions:
  local einsum contributions + one ``psum`` pair, after which every
  device holds identical synergies (S is replicated over time shards,
  like H in the sharded MU solver);
- the C update's lag sums read ``D-1`` rows *ahead*, i.e. the right
  neighbor's first rows of X and of the reconstruction — each shard
  computes its own reconstruction rows exactly (using its left halo),
  so one right-halo exchange of ``(X, X̂)`` closes the update with no
  recomputation.

Everything is exact: shard-for-shard bit-parity with
:func:`muscle_synergies_tpu.models.cnmf.fit_cnmf_batch` up to float
reordering of the psums, tested on the 8-device CPU mesh.  The
convergence loop reuses the sharded solvers' sklearn-stopping driver
inside ``shard_map`` — one compiled program per device, zero host
round-trips.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..models.cnmf import CNMFState
from ..models.mu import EPSILON, full_precision
from .collectives import axis_sum, edge_shift, time_sum
from .nmf import DATA_AXIS, TIME_AXIS, _convergence_driver
from .mesh import MODEL_AXIS

__all__ = ["sharded_fit_cnmf", "sharded_fit_cnmf_tp"]


def _lag_stack_sharded(c, n_lags: int, axis_name: str):
    """Local slice of the GLOBAL lag stack: ``(t_loc, K) -> (D, t_loc, K)``.

    Rows shifted past the local shard's start come from the left
    neighbor's tail (zeros at the global edge).
    """
    halo = n_lags - 1
    if halo == 0:
        return c[None]
    ext = jnp.concatenate([edge_shift(c[-halo:], axis_name, 1), c])
    t_loc = c.shape[0]
    return jnp.stack([ext[halo - d : halo - d + t_loc] for d in range(n_lags)])


@full_precision
def _local_cnmf_step(x, c, s, axis_name: str, n_lags: int,
                     precision=None):
    """One S-then-C multiplicative update on a single trial's shards.

    Mirrors :func:`muscle_synergies_tpu.models.cnmf.cnmf_update`
    exactly; x ``(t_loc, L)``, c ``(t_loc, K)``, s ``(K, D, L)``
    (replicated over the time group).
    """
    halo = n_lags - 1

    cs = _lag_stack_sharded(c, n_lags, axis_name)
    xhat = jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
    num_s = time_sum(
        jnp.einsum("dtk,tl->kdl", cs, x, precision=precision), axis_name
    )
    den_s = time_sum(
        jnp.einsum("dtk,tl->kdl", cs, xhat, precision=precision), axis_name
    )
    s = s * (num_s / jnp.where(den_s == 0, EPSILON, den_s))

    cs = _lag_stack_sharded(c, n_lags, axis_name)
    xhat = jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
    if halo:
        x_ext = jnp.concatenate([x, edge_shift(x[:halo], axis_name, -1)])
        xh_ext = jnp.concatenate(
            [xhat, edge_shift(xhat[:halo], axis_name, -1)]
        )
    else:
        x_ext, xh_ext = x, xhat
    g_num = jnp.einsum("tl,kdl->dtk", x_ext, s, precision=precision)
    g_den = jnp.einsum("tl,kdl->dtk", xh_ext, s, precision=precision)
    t_loc = x.shape[0]
    num_c = sum(g_num[d, d : d + t_loc] for d in range(n_lags))
    den_c = sum(g_den[d, d : d + t_loc] for d in range(n_lags))
    c = c * (num_c / jnp.where(den_c == 0, EPSILON, den_c))
    return c, s


def _local_cnmf_error(x, c, s, axis_name: str, n_lags: int,
                      precision=None):
    """Frobenius error of the convolutive reconstruction, time-psum'd."""
    cs = _lag_stack_sharded(c, n_lags, axis_name)
    diff = x - jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
    return jnp.sqrt(time_sum(jnp.sum(diff * diff), axis_name))


def sharded_fit_cnmf(
    xs: jnp.ndarray,
    c0: jnp.ndarray,
    s0: jnp.ndarray,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    precision=None,
) -> CNMFState:
    """Run batched convolutive NMF on a ``(data, time)`` mesh.

    Args:
        xs: ``(B, T, L)`` trials, sharded ``P(data, time, None)``.
        c0: ``(B, T, K)`` activations, sharded like ``xs``.
        s0: ``(B, K, D, L)`` synergies, sharded ``P(data)`` only
            (replicated over the time groups).

    Returns:
        :class:`CNMFState` with the same sharding; semantics match
        :func:`~muscle_synergies_tpu.models.cnmf.fit_cnmf_batch`
        (per-trial sklearn stopping, converged trials frozen).
        ``precision`` threads through the update contractions,
        matching the local solver's knob (models/cnmf.py docstrings);
        the stopping criterion's error checks default to
        ``Precision.HIGHEST`` regardless, like
        :func:`~muscle_synergies_tpu.models.cnmf.fit_cnmf`.
    """
    check_precision = (
        precision if precision is not None else jax.lax.Precision.HIGHEST
    )
    n_lags = s0.shape[2]
    t = xs.shape[1]
    n_time = mesh.shape[TIME_AXIS]
    if t % n_time:
        raise ValueError(
            f"time length {t} must divide over {n_time} time shards"
        )
    if n_lags - 1 > t // n_time:
        raise ValueError(
            f"lag halo {n_lags - 1} exceeds one time shard "
            f"({t // n_time} samples); use fewer time shards or lags"
        )
    vstep = jax.vmap(
        lambda x, c, s: _local_cnmf_step(
            x, c, s, TIME_AXIS, n_lags, precision=precision
        )
    )
    verr = jax.vmap(
        lambda x, c, s: _local_cnmf_error(
            x, c, s, TIME_AXIS, n_lags, precision=check_precision
        )
    )

    def step(xb, cb, sb, _axis):
        return vstep(xb, cb, sb)

    def error(xb, cb, sb, _axis):
        return verr(xb, cb, sb)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, TIME_AXIS, None),
            P(DATA_AXIS, None, None, None),
        ),
        out_specs=CNMFState(
            c=P(DATA_AXIS, TIME_AXIS, None),
            s=P(DATA_AXIS, None, None, None),
            n_iter=P(DATA_AXIS),
            previous_error=P(DATA_AXIS),
            converged=P(DATA_AXIS),
        ),
    )
    def fit(xb, cb, sb):
        return _convergence_driver(
            xb, cb, sb, step, error, TIME_AXIS, CNMFState,
            max_iter, tol, check_every,
        )

    return fit(xs, c0, s0)


@full_precision
def _local_cnmf_step_tp(x, c, s, axis_name: str, n_lags: int,
                        precision=None):
    """One convolutive update on a single trial's CHANNEL shards.

    Time is unsharded here (full ``T`` local, so the lag stack needs no
    halos); channels split over the model axis.  The S update is fully
    local — its per-``(k, d, l)`` projections never mix channels — and
    only the C update's channel sums cross shards, as one ``psum`` pair
    per iteration (after which every shard computes the identical C,
    keeping it replicated).  Shapes: x ``(T, l_loc)``, c ``(T, K)``
    (replicated over the model group), s ``(K, D, l_loc)``.
    """
    cs = _lag_stack_local(c, n_lags)
    xhat = jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
    num_s = jnp.einsum("dtk,tl->kdl", cs, x, precision=precision)
    den_s = jnp.einsum("dtk,tl->kdl", cs, xhat, precision=precision)
    s = s * (num_s / jnp.where(den_s == 0, EPSILON, den_s))

    cs = _lag_stack_local(c, n_lags)
    xhat = jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
    g_num = axis_sum(
        jnp.einsum("tl,kdl->dtk", x, s, precision=precision), axis_name
    )
    g_den = axis_sum(
        jnp.einsum("tl,kdl->dtk", xhat, s, precision=precision), axis_name
    )
    num_c = sum(
        jnp.concatenate(
            [g_num[d, d:], jnp.zeros((d, g_num.shape[2]), g_num.dtype)]
        )
        for d in range(n_lags)
    )
    den_c = sum(
        jnp.concatenate(
            [g_den[d, d:], jnp.zeros((d, g_den.shape[2]), g_den.dtype)]
        )
        for d in range(n_lags)
    )
    c = c * (num_c / jnp.where(den_c == 0, EPSILON, den_c))
    return c, s


def _lag_stack_local(c, n_lags: int):
    """``(T, K) -> (D, T, K)`` causal lag stack, no sharding involved."""
    t = c.shape[0]
    return jnp.stack([
        c if d == 0 else jnp.concatenate(
            [jnp.zeros((d, c.shape[1]), c.dtype), c[: t - d]]
        )
        for d in range(n_lags)
    ])


def _local_cnmf_error_tp(x, c, s, axis_name: str, n_lags: int,
                         precision=None):
    """Frobenius error with the channel sums ``psum``'d."""
    cs = _lag_stack_local(c, n_lags)
    diff = x - jnp.einsum("dtk,kdl->tl", cs, s, precision=precision)
    return jnp.sqrt(axis_sum(jnp.sum(diff * diff), axis_name))


def sharded_fit_cnmf_tp(
    xs: jnp.ndarray,
    c0: jnp.ndarray,
    s0: jnp.ndarray,
    mesh: Mesh,
    max_iter: int = 200,
    tol: float = 1e-4,
    check_every: int = 10,
    precision=None,
) -> CNMFState:
    """Run batched convolutive NMF on a ``(data, model)`` mesh.

    The tensor-parallel counterpart of :func:`sharded_fit_cnmf` for
    wide-channel layouts (many muscles / high-density EMG grids): the
    synergy library and ``X``'s channel axis shard over ``"model"``,
    the activations stay replicated within a model group, and the only
    communication is the C update's channel-summed ``psum`` pair plus
    the convergence check — the convolutive analog of
    :func:`~muscle_synergies_tpu.parallel.sharded_fit_mu_tp`.

    Args:
        xs: ``(B, T, L)`` trials, sharded ``P(data, None, model)``.
        c0: ``(B, T, K)`` activations, sharded ``P(data)`` only.
        s0: ``(B, K, D, L)`` synergies, sharded ``P(data, None, None,
            model)``.

    Returns:
        :class:`CNMFState` with the same sharding; semantics match
        :func:`~muscle_synergies_tpu.models.cnmf.fit_cnmf_batch`.
    """
    n_lags = s0.shape[2]
    n_model = mesh.shape[MODEL_AXIS]
    if xs.shape[2] % n_model:
        raise ValueError(
            f"channel count {xs.shape[2]} must divide over {n_model} "
            "model shards"
        )
    vstep = jax.vmap(
        lambda x, c, s: _local_cnmf_step_tp(
            x, c, s, MODEL_AXIS, n_lags, precision=precision
        )
    )
    verr = jax.vmap(
        lambda x, c, s: _local_cnmf_error_tp(
            x, c, s, MODEL_AXIS, n_lags, precision=precision
        )
    )

    def step(xb, cb, sb, _axis):
        return vstep(xb, cb, sb)

    def error(xb, cb, sb, _axis):
        return verr(xb, cb, sb)

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(DATA_AXIS, None, MODEL_AXIS),
            P(DATA_AXIS, None, None),
            P(DATA_AXIS, None, None, MODEL_AXIS),
        ),
        out_specs=CNMFState(
            c=P(DATA_AXIS, None, None),
            s=P(DATA_AXIS, None, None, MODEL_AXIS),
            n_iter=P(DATA_AXIS),
            previous_error=P(DATA_AXIS),
            converged=P(DATA_AXIS),
        ),
    )
    def fit(xb, cb, sb):
        return _convergence_driver(
            xb, cb, sb, step, error, MODEL_AXIS, CNMFState,
            max_iter, tol, check_every,
        )

    return fit(xs, c0, s0)
