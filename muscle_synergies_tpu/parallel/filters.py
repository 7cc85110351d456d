"""Time-sharded IIR filtering: exact sequence parallelism over a mesh.

The reference filters a 124k-sample EMG capture in one host
``sosfiltfilt`` call (reference analysis.py:417).  Here the time axis
shards across devices and each second-order section runs as:

1. every device computes its *local* cumulative affine state maps
   (the same parallel prefix used by the single-device scan in
   :mod:`muscle_synergies_tpu.ops.filters`);
2. the per-device boundary transforms — a 2x2 matrix and a 2-vector
   per channel, a few hundred bytes — are ``all_gather``-ed over the
   ``time`` axis;
3. each device composes the transforms of the devices before it to get
   its exact incoming filter state, then emits its block's output.

This reproduces the sequential recurrence exactly (up to float
reordering) with communication volume independent of sequence length —
the IIR analog of ring-attention-style sequence parallelism, but
without approximation.  Zero-phase filtering reuses the machinery
right-to-left; scipy's odd-reflection edge padding is evaluated on the
edge-owning devices and enters the sharded passes through per-section
initial states, so no resharding or ragged blocks are needed.

All loops over cascade sections and mesh neighbors are ``lax.scan`` /
``fori_loop``, keeping the compiled SPMD program size independent of
filter order and device count.
"""

from __future__ import annotations

import functools
import weakref
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.filters import (
    _emit_output,
    _normalize_sos,
    _section_prefix,
    sosfilt_zi,
)
from .collectives import (
    axis_index,
    axis_size,
    gather_time,
    mark_varying,
    ring_shift,
)
from .mesh import TIME_AXIS

__all__ = ["sharded_sosfilt", "sharded_sosfiltfilt", "sharded_moving_rms"]


def _compose_incoming(boundary, my_idx, n_dev, s_init, reverse: bool):
    """State entering this device: fold boundary transforms before it.

    ``boundary`` is the all-gathered per-device block transform
    ``(a11, a12, a21, a22, b1, b2)`` (leading axis = device).  Devices
    fold in processing order (device 0 first, or device ``n_dev-1``
    first when ``reverse``), starting from the global initial state
    ``s_init`` of shape ``(2, C)``.
    """
    a11, a12, a21, a22, b1, b2 = boundary

    def body(j, s):
        s1, s2 = s
        dev = (n_dev - 1 - j) if reverse else j
        applies = (j < (n_dev - 1 - my_idx)) if reverse else (j < my_idx)
        new_s1 = a11[dev] * s1 + a12[dev] * s2 + b1[dev]
        new_s2 = a21[dev] * s1 + a22[dev] * s2 + b2[dev]
        return (
            jnp.where(applies, new_s1, s1),
            jnp.where(applies, new_s2, s2),
        )

    s1, s2 = jax.lax.fori_loop(0, n_dev - 1, body, (s_init[0], s_init[1]))
    return jnp.stack([s1, s2])


def _section_block(x, coeffs, s_init, axis_name, reverse: bool):
    """One section over a time-sharded block (one tiny all_gather).

    ``s_init`` is the state entering the globally-first sample of the
    pass (the last device's block leads when ``reverse``).  Returns the
    local output block and this device's exit state.
    """
    if reverse:
        x = x[::-1]
    prefix = _section_prefix(x, coeffs)
    p11, p12, p21, p22, d1, d2 = prefix
    c = x.shape[1]
    ones = jnp.ones((c,), x.dtype)
    boundary_local = (
        p11[-1] * ones, p12[-1] * ones, p21[-1] * ones, p22[-1] * ones,
        d1[-1], d2[-1],
    )
    gathered = gather_time(boundary_local, axis_name)
    my_idx = axis_index(axis_name)
    n_dev = axis_size(axis_name)
    s_in = _compose_incoming(gathered, my_idx, n_dev, s_init, reverse)
    y, zf = _emit_output(x, coeffs, prefix, s_in)
    if reverse:
        y = y[::-1]
    return y, zf


def _sharded_pass(x, sos_j, entry_states, axis_name, reverse: bool):
    """Full cascade over sharded blocks (scan over sections).

    ``entry_states``: ``(n_sections, 2, C)``.  Returns the local output
    and this device's per-section exit states.
    """

    def body(y, sec):
        coeffs, s_init = sec
        y, zf = _section_block(y, coeffs, s_init, axis_name, reverse)
        return y, zf

    return jax.lax.scan(body, x, (sos_j, entry_states))


def _cascade_block(block, sos_j, entry_states):
    """Run a small local block through the whole cascade (no comm)."""

    def body(blk, sec):
        coeffs, s_init = sec
        prefix = _section_prefix(blk, coeffs)
        blk, zf = _emit_output(blk, coeffs, prefix, s_init)
        return blk, zf

    return jax.lax.scan(body, block, (sos_j, entry_states))


def _owned(states: jnp.ndarray, owner: int, axis_name: str) -> jnp.ndarray:
    """Broadcast ``(n_sections, 2, C)`` states from their owning device."""
    return gather_time(states, axis_name)[owner]


def sharded_sosfilt(
    sos: np.ndarray,
    x: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
) -> jnp.ndarray:
    """Causal SOS filtering of a time-sharded ``(N, C)`` signal.

    Equivalent to :func:`muscle_synergies_tpu.ops.filters.sosfilt` with
    zero initial state, with the time axis sharded over ``axis_name``.
    Any signal length is accepted: indivisible lengths are zero-padded
    at the end to the device count (a causal filter's first ``N``
    outputs are unaffected by appended samples) and trimmed.
    """
    sos_j = jnp.asarray(_normalize_sos(sos), dtype=x.dtype)
    n_dev = mesh.shape[axis_name]
    n = x.shape[0]
    extra = (-n) % n_dev
    if extra:
        x = jnp.concatenate(
            [x, jnp.zeros((extra, x.shape[1]), x.dtype)], axis=0
        )

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None),),
        out_specs=P(axis_name, None),
    )
    def run(xb):
        c = xb.shape[1]
        zeros = jnp.zeros((sos_j.shape[0], 2, c), xb.dtype)
        zeros = mark_varying(zeros, axis_name)
        y, _ = _sharded_pass(xb, sos_j, zeros, axis_name, reverse=False)
        return y

    y = run(x)
    return y[:n] if extra else y


def sharded_sosfiltfilt(
    sos: np.ndarray,
    x: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
    padtype: Optional[str] = "odd",
    padlen: Optional[int] = None,
) -> jnp.ndarray:
    """Zero-phase SOS filtering of a time-sharded ``(N, C)`` signal.

    scipy-``sosfiltfilt`` semantics with the time axis sharded over
    ``axis_name``, including the full edge-extension surface of the
    local API (:func:`muscle_synergies_tpu.ops.filters.sosfiltfilt`):
    ``padtype`` is ``"odd"`` (default), ``"even"``, ``"constant"`` or
    ``None`` (no extension; ``padlen`` forced to 0).  The edge pads are
    built from the global edges (a ``padlen x C`` slice each) and
    forward filtered redundantly on every device; only per-section
    filter states and the per-device boundary transforms cross devices.

    The API is total over signal lengths (exactness is unconditional):

    * when ``N`` does not divide the mesh, the first samples of the
      right extension pad are appended to the data blocks — the
      extended sequence equals scipy's internal extension, so the
      result is still exact — and the output is trimmed back to ``N``;
    * when more padding would be needed than the extension provides
      (``N`` smaller than the device count, roughly — always the case
      for ``padtype=None`` on indivisible lengths), the computation
      automatically falls back to the single-device
      :func:`muscle_synergies_tpu.ops.filters.sosfiltfilt` on the
      gathered signal, re-placed on the mesh's time sharding.

    Raises:
        ValueError: if ``padlen >= N`` (scipy's contract) or
            ``padtype`` is not one of the four accepted values.
    """
    from ..ops.filters import _resolve_padding

    sos_np = _normalize_sos(sos)
    n_dev = mesh.shape[axis_name]
    n = x.shape[0]
    padlen = _resolve_padding(sos_np, n, padtype, padlen)
    extra = (-n) % n_dev
    if extra > padlen:
        # fewer extension samples than the divisibility gap (signal
        # shorter than roughly the device count): gather and run the
        # single-device kernel; such a signal cannot usefully shard,
        # so the result stays on the default placement
        from ..ops.filters import sosfiltfilt as _local_sosfiltfilt

        return _local_sosfiltfilt(sos_np, x, padtype=padtype, padlen=padlen)

    zi_unit = jnp.asarray(sosfilt_zi(sos_np), dtype=x.dtype)
    sos_j = jnp.asarray(sos_np, dtype=x.dtype)
    run_all = _build_sharded_filtfilt(
        mesh, axis_name, padlen, extra, padtype if padlen > 0 else None
    )
    return run_all(sos_j, zi_unit, x)


def sharded_moving_rms(
    x: jnp.ndarray,
    window: int,
    mesh: Mesh,
    axis_name: str = TIME_AXIS,
) -> jnp.ndarray:
    """Moving-window RMS of a time-sharded ``(N, C)`` signal.

    Exact twin of :func:`muscle_synergies_tpu.ops.emg.moving_rms`
    (``np.convolve(sq, ones(w)/w, 'same')`` semantics with zero-padded
    edges — the reference's RMS, reference analysis.py:474-491) with
    the sample axis sharded over ``axis_name``.  Unlike the IIR
    filters' state-sized boundary transforms, the box window is an FIR
    kernel, so the communication is a classic *halo exchange*: each
    device ``ppermute``-shifts its block tail/head to its neighbors
    (``w//2`` samples left, ``(w-1)//2`` right), runs the
    compensated-cumsum window difference on the extended block, and
    trims.  The global zero-padding falls out naturally: the first and
    last devices mask their missing halos to zero, which IS the
    ``'same'``-mode edge behavior.

    Total over signal lengths (results exact up to float reordering):
    indivisible ``N`` is zero-padded to the device count (appended
    zeros cannot change any in-range window — that is what 'same'
    zero-padding means) and trimmed; a window whose halo exceeds one
    block (signal too short to usefully shard) falls back to the
    single-device kernel.

    Raises:
        ValueError: if ``window < 1`` or ``window > N`` (the local
            API's contract).
    """
    window = int(window)
    if window < 1:
        raise ValueError(
            f"window must contain at least one sample, got {window}"
        )
    n, c = x.shape
    if window > n:
        raise ValueError(
            f"window ({window} samples) is longer than the signal "
            f"({n} samples)"
        )
    n_dev = mesh.shape[axis_name]
    block = -(-n // n_dev)
    hl, hr = window // 2, (window - 1) // 2
    if hl > block or hr > block:
        from ..ops.emg import moving_rms as _local_moving_rms

        return _local_moving_rms(x, window)
    run_all = _build_sharded_rms(mesh, axis_name, window, n)
    return run_all(x)


def _build_sharded_rms(mesh: Mesh, axis_name: str, window: int, n: int):
    per_mesh = _RMS_CACHE.setdefault(mesh, {})
    key = (axis_name, window, n)
    if key not in per_mesh:
        per_mesh[key] = _trace_sharded_rms(mesh, axis_name, window, n)
    return per_mesh[key]


def _trace_sharded_rms(mesh: Mesh, axis_name: str, window: int, n: int):
    """One jitted program per (mesh, window, length): pad + halo + trim."""
    from ..ops.emg import _df_add

    n_dev = mesh.shape[axis_name]
    extra = (-n) % n_dev
    hl, hr = window // 2, (window - 1) // 2

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None),),
        out_specs=P(axis_name, None),
    )
    def run(xb):
        idx = axis_index(axis_name)
        nd = axis_size(axis_name)
        parts = []
        if hl:
            left = ring_shift(xb[-hl:], axis_name, shift=1)
            parts.append(jnp.where(idx > 0, left, 0.0))
        parts.append(xb)
        if hr:
            right = ring_shift(xb[:hr], axis_name, shift=-1)
            parts.append(jnp.where(idx < nd - 1, right, 0.0))
        ext = jnp.concatenate(parts, axis=0) if len(parts) > 1 else xb
        square = ext * ext
        cs_hi, cs_lo = jax.lax.associative_scan(
            _df_add, (square, jnp.zeros_like(square)), axis=0
        )
        zero = jnp.zeros((1, ext.shape[1]), ext.dtype)
        cs_hi = jnp.concatenate([zero, cs_hi])
        cs_lo = jnp.concatenate([zero, cs_lo])
        nb = xb.shape[0]
        win_sum = (cs_hi[window : window + nb] - cs_hi[:nb]) + (
            cs_lo[window : window + nb] - cs_lo[:nb]
        )
        return jnp.sqrt(jnp.maximum(win_sum / window, 0.0))

    @jax.jit
    def run_all(x):
        if extra:
            x = jnp.concatenate(
                [x, jnp.zeros((extra, x.shape[1]), x.dtype)], axis=0
            )
        y = run(x)
        return y[:n] if extra else y

    return run_all


# Program caches keyed WEAKLY on the mesh: meshes (and the devices they
# reference) are released when the caller drops theirs, instead of being
# pinned for the process lifetime as an lru_cache key would.  The inner
# dict (pad-geometry key -> jitted program) lives and dies with its mesh.
_FILTFILT_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_RMS_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _build_sharded_filtfilt(
    mesh: Mesh, axis_name: str, padlen: int, extra: int,
    padtype: Optional[str] = "odd",
):
    per_mesh = _FILTFILT_CACHE.setdefault(mesh, {})
    key = (axis_name, padlen, extra, padtype)
    if key not in per_mesh:
        per_mesh[key] = _trace_sharded_filtfilt(
            mesh, axis_name, padlen, extra, padtype
        )
    return per_mesh[key]


def _trace_sharded_filtfilt(
    mesh: Mesh, axis_name: str, padlen: int, extra: int,
    padtype: Optional[str],
):
    """One jitted program per (mesh, pad geometry): pads + passes + trim.

    Everything — edge-pad construction, the left-pad forward filter,
    the sharded passes and the output trim — traces into a single
    ``jit`` so an eager caller issues ONE dispatch instead of one per
    glue op.  Filter coefficients are traced arguments, so new designs
    reuse the compiled program.
    """
    rem = padlen - extra

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(axis_name, None),
            P(None, None),
            P(None, None, None),
            P(None, None),
            P(None, None),
        ),
        out_specs=P(axis_name, None),
    )
    def run(xb, rem_b, fwd_states_b, sos_b, zi_b):
        # replicated operands feed varying loop carries inside the
        # sharded pass — mark them so check_vma accepts the while/scan
        fwd_states_b = mark_varying(fwd_states_b, axis_name)
        rem_b = mark_varying(rem_b, axis_name)
        y, data_exit_local = _sharded_pass(
            xb, sos_b, fwd_states_b, axis_name, reverse=False
        )
        # per-section state at the global end of the data, owned by the
        # last device and broadcast through the gather
        end_states = _owned(data_exit_local, -1, axis_name)

        # ---- forward-filter the remaining right pad, then reverse it
        # to seed the backward pass (replicated: every device computes
        # the same few-sample block) ----
        if rem > 0:
            fwd_right, _ = _cascade_block(rem_b, sos_b, end_states)
            y0 = fwd_right[-1]
            bwd_entry = zi_b[:, :, None] * y0
            _, bwd_states = _cascade_block(
                fwd_right[::-1], sos_b, bwd_entry
            )
        else:
            # the whole reflection rode with the data blocks: the
            # backward pass seeds directly from the global last
            # forward-filtered sample
            y0 = gather_time(y[-1], axis_name)[-1]
            bwd_states = zi_b[:, :, None] * y0

        # ---- backward pass over the data blocks ----
        out, _ = _sharded_pass(y, sos_b, bwd_states, axis_name, reverse=True)
        return out

    @jax.jit
    def run_all(sos_j, zi_unit, x):
        n = x.shape[0]
        # Both edge pads come from the global edges — tiny (padlen, C)
        # slices — and the left one forward-filters replicated into
        # the sharded passes' initial states.
        if padlen > 0:
            if padtype == "odd":
                left_pad = 2 * x[0] - x[padlen:0:-1]
                right_refl = 2 * x[-1] - x[-2 : -padlen - 2 : -1]
            elif padtype == "even":
                left_pad = x[padlen:0:-1]
                right_refl = x[-2 : -padlen - 2 : -1]
            else:  # "constant"
                left_pad = jnp.broadcast_to(x[0], (padlen,) + x.shape[1:])
                right_refl = jnp.broadcast_to(
                    x[-1], (padlen,) + x.shape[1:]
                )
            pad_entry = zi_unit[:, :, None] * left_pad[0]
            _, fwd_states = _cascade_block(left_pad, sos_j, pad_entry)
        else:
            fwd_states = zi_unit[:, :, None] * x[0]
            right_refl = x[:0]
        x_ext = (
            jnp.concatenate([x, right_refl[:extra]], axis=0) if extra else x
        )
        right_rem = right_refl[extra:]  # (padlen - extra, C)
        out = run(x_ext, right_rem, fwd_states, sos_j, zi_unit)
        return out[:n] if extra else out

    return run_all
