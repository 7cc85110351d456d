"""IIR digital filtering as parallel scans.

Capability parity with the reference ``digital_filter``
(reference: src/muscle_synergies/analysis.py:314-432), which delegates
to ``scipy.signal.sosfilt``/``sosfiltfilt``.  Here the *design* stage
(tiny, scalar, host-side) produces second-order sections with scipy,
while the *application* stage — the hot path over ``(time, channels)``
blocks — is a JAX computation built on ``jax.lax.associative_scan``:

Each second-order section (direct-form II transposed, ``a0 = 1``) is a
linear recurrence on a 2-vector of filter states::

    s[n] = A s[n-1] + B x[n]        y[n] = b0 x[n] + s1[n-1]
    A = [[-a1, 1], [-a2, 0]]        B = [b1 - a1 b0, b2 - a2 b0]

Affine maps compose associatively, so the whole recurrence is a
parallel prefix scan over ``(A, B x[n])`` pairs — O(N log N) work with
large fused element-wise blocks instead of an O(N) sequential loop,
which XLA parallelizes across long captures (124k+ samples); it vmaps
cleanly over channels and trials.

Zero-phase (``filtfilt``) semantics replicate scipy's defaults exactly:
odd-reflection padding with ``padlen = 3 * (2 * n_sections + 1 -
min(#{b2==0}, #{a2==0}))`` and steady-state initial conditions scaled
by the first sample (``sosfilt_zi`` equivalent), so results match
``scipy.signal.sosfiltfilt`` to floating-point accuracy.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from scipy import signal as _scipy_signal

__all__ = [
    "sos_design",
    "sosfilt_zi",
    "sosfilt",
    "sosfiltfilt",
    "default_padlen",
]


def sos_design(
    order: int,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    filter_type: str = "butter",
    band_type: str = "lowpass",
    cheby_param: Optional[float] = None,
) -> np.ndarray:
    """Design an IIR filter, returning ``(n_sections, 6)`` SOS in float64.

    Example:
        >>> sos_design(4, 10.0, 2000.0).shape
        (2, 6)

    Args:
        order: filter order.
        critical_freqs: cutoff (scalar for low/highpass, pair for
            bandpass/bandstop), in the same units as
            ``sampling_frequency``.
        sampling_frequency: sampling rate in Hz.
        filter_type: ``"butter"``, ``"cheby1"`` or ``"cheby2"``.
        band_type: ``"lowpass"``, ``"highpass"``, ``"bandpass"`` or
            ``"bandstop"``.
        cheby_param: passband ripple (cheby1) or stopband attenuation
            (cheby2) in positive dB; ignored for Butterworth.
    """
    if filter_type == "butter":
        return _scipy_signal.butter(
            order,
            critical_freqs,
            btype=band_type,
            output="sos",
            fs=sampling_frequency,
        )
    if filter_type == "cheby1":
        design = _scipy_signal.cheby1
    elif filter_type == "cheby2":
        design = _scipy_signal.cheby2
    else:
        raise ValueError("filter type not understood.")
    return design(
        order,
        cheby_param,
        critical_freqs,
        btype=band_type,
        output="sos",
        fs=sampling_frequency,
    )


def _normalize_sos(sos: np.ndarray) -> np.ndarray:
    sos = np.asarray(sos, dtype=np.float64)
    if sos.ndim != 2 or sos.shape[1] != 6:
        raise ValueError(f"sos must have shape (n_sections, 6), got {sos.shape}")
    return sos / sos[:, 3:4]  # enforce a0 == 1


def sosfilt_zi(sos: np.ndarray) -> np.ndarray:
    """Steady-state filter states for a unit step, shape ``(n_sections, 2)``.

    Equivalent to ``scipy.signal.sosfilt_zi``: per-section steady state
    ``zi = (I - A)^-1 B`` scaled by the cumulative DC gain of the
    preceding sections.
    """
    sos = _normalize_sos(sos)
    n_sections = sos.shape[0]
    zi = np.empty((n_sections, 2))
    scale = 1.0
    for k in range(n_sections):
        b0, b1, b2, _, a1, a2 = sos[k]
        A = np.array([[-a1, 1.0], [-a2, 0.0]])
        B = np.array([b1 - a1 * b0, b2 - a2 * b0])
        zi[k] = scale * np.linalg.solve(np.eye(2) - A, B)
        scale *= (b0 + b1 + b2) / (1.0 + a1 + a2)  # section DC gain
    return zi


def default_padlen(sos: np.ndarray) -> int:
    """scipy's default ``sosfiltfilt`` pad length for this cascade."""
    sos = np.asarray(sos)
    n_sections = sos.shape[0]
    ntaps = 2 * n_sections + 1
    ntaps -= min((sos[:, 2] == 0).sum(), (sos[:, 5] == 0).sum())
    return 3 * ntaps


def _affine_combine(left, right):
    """Compose affine state maps: (A, c) pairs, right after left."""
    l11, l12, l21, l22, lc1, lc2 = left
    r11, r12, r21, r22, rc1, rc2 = right
    return (
        r11 * l11 + r12 * l21,
        r11 * l12 + r12 * l22,
        r21 * l11 + r22 * l21,
        r21 * l12 + r22 * l22,
        r11 * lc1 + r12 * lc2 + rc1,
        r21 * lc1 + r22 * lc2 + rc2,
    )


def _section_prefix(x: jnp.ndarray, coeffs: jnp.ndarray):
    """Cumulative affine state maps of one section over ``x``.

    Returns ``(p11, p12, p21, p22, d1, d2)`` such that the section
    state after sample ``n`` is ``s[n] = P[n] @ s_init + d[n]`` — the
    building block shared by the single-device scan and the
    time-sharded (sequence-parallel) filter in
    :mod:`muscle_synergies_tpu.parallel.filters`.
    """
    n = x.shape[0]
    b0, b1, b2, _, a1, a2 = (coeffs[i] for i in range(6))

    ones = jnp.ones((n, 1), dtype=x.dtype)
    a11 = -a1 * ones
    a12 = ones
    a21 = -a2 * ones
    a22 = jnp.zeros((n, 1), dtype=x.dtype)
    c1 = (b1 - a1 * b0) * x
    c2 = (b2 - a2 * b0) * x

    return jax.lax.associative_scan(
        _affine_combine, (a11, a12, a21, a22, c1, c2), axis=0
    )


def _emit_output(x, coeffs, prefix, zi):
    """Section output from cumulative maps and the incoming state."""
    b0 = coeffs[0]
    p11, p12, p21, p22, d1, d2 = prefix
    z1 = p11 * zi[0] + p12 * zi[1] + d1
    z2 = p21 * zi[0] + p22 * zi[1] + d2
    z1_prev = jnp.concatenate(
        [jnp.broadcast_to(zi[0], (1,) + z1.shape[1:]), z1[:-1]]
    )
    y = b0 * x + z1_prev
    zf = jnp.stack([z1[-1], z2[-1]])
    return y, zf


def _section_scan_blocked(
    x: jnp.ndarray, coeffs: jnp.ndarray, zi: jnp.ndarray, n_chunks: int
):
    """Blocked variant of :func:`_section_scan` for long signals.

    A ``(N, C)`` array with few channels wastes almost the whole
    128-wide lane tile, which makes the naive scan memory-layout bound.
    This path splits time into ``n_chunks`` chunks and lays the signal
    out as ``(L, n_chunks * C)`` — chunks ride the lane dimension at
    full width — then:

    1. one associative scan of length ``L = ceil(N / n_chunks)``
       computes every chunk's cumulative maps in parallel;
    2. a tiny ``lax.scan`` over the ``n_chunks`` boundary transforms
       chains the chunks' incoming states exactly (the same
       composition the mesh-sharded filter does across devices);
    3. the outputs are emitted per chunk and restitched.

    Bit-equivalent to the sequential recurrence up to float reordering.
    """
    n, c = x.shape
    l = -(-n // n_chunks)  # ceil
    pad = l * n_chunks - n
    x_p = jnp.pad(x, ((0, pad), (0, 0)))
    # (L, M*C): row i holds sample i of every chunk
    xb = jnp.transpose(
        x_p.reshape(n_chunks, l, c), (1, 0, 2)
    ).reshape(l, n_chunks * c)

    prefix = _section_prefix(xb, coeffs)
    p11, p12, p21, p22, d1, d2 = prefix

    # chunk boundary transforms: A_tot is data-independent (same A^L
    # for every chunk); d_tot differs per chunk
    a_tot = jnp.stack(
        [p11[-1, 0], p12[-1, 0], p21[-1, 0], p22[-1, 0]]
    )  # (4,)
    d_tot = jnp.stack(
        [d1[-1].reshape(n_chunks, c), d2[-1].reshape(n_chunks, c)], axis=1
    )  # (M, 2, C)

    def compose(s, d):
        s1 = a_tot[0] * s[0] + a_tot[1] * s[1] + d[0]
        s2 = a_tot[2] * s[0] + a_tot[3] * s[1] + d[1]
        return jnp.stack([s1, s2]), s

    _, s_in = jax.lax.scan(compose, zi, d_tot)  # (M, 2, C) entry states
    s_in_flat = jnp.transpose(s_in, (1, 0, 2)).reshape(2, n_chunks * c)

    y, _ = _emit_output(xb, coeffs, prefix, s_in_flat)
    y = jnp.transpose(
        y.reshape(l, n_chunks, c), (1, 0, 2)
    ).reshape(l * n_chunks, c)[:n]

    # exact final state: sample n-1 lives in chunk (n-1)//L (padding can
    # span whole trailing chunks)
    chunk_idx = (n - 1) // l
    row = (n - 1) % l
    lanes = slice(chunk_idx * c, (chunk_idx + 1) * c)
    s_chunk_in = s_in[chunk_idx]  # (2, C)
    z1_f = p11[row, 0] * s_chunk_in[0] + p12[row, 0] * s_chunk_in[1] + d1[row, lanes]
    z2_f = p21[row, 0] * s_chunk_in[0] + p22[row, 0] * s_chunk_in[1] + d2[row, lanes]
    return y, jnp.stack([z1_f, z2_f])


# Below this many samples the plain scan's layout waste is irrelevant.
_BLOCKED_SCAN_MIN_SAMPLES = 8192


def _section_scan(x: jnp.ndarray, coeffs: jnp.ndarray, zi: jnp.ndarray):
    """Run one second-order section over ``x`` via associative scan.

    Args:
        x: ``(N, C)`` input block (time major).
        coeffs: ``(6,)`` section coefficients ``b0 b1 b2 a0 a1 a2``.
        zi: ``(2, C)`` initial state (z1, z2 rows).

    Returns:
        ``(y, zf)``: filtered block and final state ``(2, C)``.
    """
    n, c = x.shape
    if n >= _BLOCKED_SCAN_MIN_SAMPLES:
        # enough chunks that chunks x channels gives >= 128 parallel
        # rows, at most 256
        n_chunks = max(1, min(256, -(-128 // c) * 8))
        if n // n_chunks >= 64:
            return _section_scan_blocked(x, coeffs, zi, n_chunks)
    prefix = _section_prefix(x, coeffs)
    return _emit_output(x, coeffs, prefix, zi)


@functools.partial(jax.jit, static_argnames=("return_zf",))
def _sosfilt_jit(sos, x, zi, return_zf=False):
    # lax.scan over sections (not a Python loop) so the compiled
    # program size is independent of cascade depth.
    def body(carry, section):
        coeffs, zi_k = section
        y, zf_k = _section_scan(carry, coeffs, zi_k)
        return y, zf_k

    y, zf = jax.lax.scan(body, x, (sos, zi))
    if return_zf:
        return y, zf
    return y


def _as_2d(x: jnp.ndarray):
    x = jnp.asarray(x)
    if x.ndim == 1:
        return x[:, None], True
    if x.ndim == 2:
        return x, False
    raise ValueError(f"expected 1-D or 2-D input, got shape {x.shape}")


def _prep_zi(zi, n_sections: int, n_channels: int, dtype) -> jnp.ndarray:
    if zi is None:
        return jnp.zeros((n_sections, 2, n_channels), dtype=dtype)
    zi = jnp.asarray(zi, dtype=dtype)
    if zi.shape == (n_sections, 2):
        zi = zi[:, :, None] * jnp.ones((n_channels,), dtype=dtype)
    elif zi.shape != (n_sections, 2, n_channels):
        raise ValueError(
            f"zi must have shape ({n_sections}, 2) or "
            f"({n_sections}, 2, {n_channels}), got {zi.shape}"
        )
    return zi


def sosfilt(
    sos: np.ndarray,
    x: jnp.ndarray,
    zi=None,
    return_zf: bool = False,
):
    """Filter ``x`` along axis 0 with an SOS cascade (scipy ``sosfilt``).

    Args:
        x: ``(N,)`` or ``(N, C)`` signal block, time major.
        zi: optional initial states, ``(n_sections, 2)`` (broadcast over
            channels) or ``(n_sections, 2, C)``.
        return_zf: also return final states ``(n_sections, 2, C)``.
    """
    x2, squeeze = _as_2d(x)
    sos_arr = jnp.asarray(_normalize_sos(sos), dtype=x2.dtype)
    zi_arr = _prep_zi(zi, sos_arr.shape[0], x2.shape[1], x2.dtype)
    out = _sosfilt_jit(sos_arr, x2, zi_arr, return_zf=return_zf)
    if return_zf:
        y, zf = out
        return (y[:, 0], zf[..., 0]) if squeeze else (y, zf)
    return out[:, 0] if squeeze else out


def _odd_ext(x: jnp.ndarray, padlen: int) -> jnp.ndarray:
    """Odd extension at both ends along axis 0 (scipy ``odd_ext``)."""
    if padlen == 0:
        return x
    left = 2 * x[0] - x[padlen:0:-1]
    right = 2 * x[-1] - x[-2 : -padlen - 2 : -1]
    return jnp.concatenate([left, x, right], axis=0)


def _even_ext(x: jnp.ndarray, padlen: int) -> jnp.ndarray:
    """Even (mirror) extension along axis 0 (scipy ``even_ext``)."""
    if padlen == 0:
        return x
    left = x[padlen:0:-1]
    right = x[-2 : -padlen - 2 : -1]
    return jnp.concatenate([left, x, right], axis=0)


def _const_ext(x: jnp.ndarray, padlen: int) -> jnp.ndarray:
    """Constant (edge-value) extension along axis 0 (scipy ``const_ext``)."""
    if padlen == 0:
        return x
    left = jnp.broadcast_to(x[0], (padlen,) + x.shape[1:])
    right = jnp.broadcast_to(x[-1], (padlen,) + x.shape[1:])
    return jnp.concatenate([left, x, right], axis=0)


_EXTENSIONS = {"odd": _odd_ext, "even": _even_ext, "constant": _const_ext}


def _resolve_padding(
    sos_np: np.ndarray, n_samples: int, padtype: Optional[str], padlen
) -> int:
    """Validate ``padtype`` and resolve ``padlen`` (scipy semantics).

    Shared by :func:`sosfiltfilt` and the sharded filtfilt so the two
    cannot drift.
    """
    if padtype not in ("odd", "even", "constant", None):
        raise ValueError(
            "padtype must be 'odd', 'even', 'constant', or None; "
            f"got {padtype!r}"
        )
    if padtype is None:
        padlen = 0
    elif padlen is None:
        padlen = default_padlen(sos_np)
    if padlen >= n_samples:
        raise ValueError(
            f"the length of the input vector x must be greater than padlen, "
            f"which is {padlen}"
        )
    return int(padlen)


def sosfiltfilt(
    sos: np.ndarray,
    x: jnp.ndarray,
    padtype: Optional[str] = "odd",
    padlen: Optional[int] = None,
) -> jnp.ndarray:
    """Zero-phase forward-backward filtering (scipy ``sosfiltfilt``).

    Edge handling replicates scipy exactly: the signal is extended by
    ``padlen`` samples at both ends (odd reflection by default; also
    ``"even"``, ``"constant"`` or ``None`` for no extension, in which
    case ``padlen`` is forced to 0), and each pass starts from
    steady-state initial conditions scaled by the first sample of its
    input, so results agree to floating-point accuracy.

    Args:
        sos: ``(n_sections, 6)`` cascade.
        x: ``(N,)`` or ``(N, C)`` block, time major.
        padtype: ``"odd"`` (default), ``"even"``, ``"constant"`` or
            ``None``.
        padlen: edge extension length; defaults to scipy's formula.
    """
    x2, squeeze = _as_2d(x)
    sos_np = _normalize_sos(sos)
    padlen = _resolve_padding(sos_np, x2.shape[0], padtype, padlen)
    zi_unit = sosfilt_zi(sos_np)  # (n_sections, 2)

    y = _sosfiltfilt_jit(
        jnp.asarray(sos_np, dtype=x2.dtype),
        x2,
        jnp.asarray(zi_unit, dtype=x2.dtype),
        padlen,
        padtype if padlen > 0 else None,
    )
    return y[:, 0] if squeeze else y


@functools.partial(jax.jit, static_argnames=("padlen", "padtype"))
def _sosfiltfilt_jit(sos, x, zi_unit, padlen, padtype="odd"):
    ext = _EXTENSIONS[padtype](x, padlen) if padtype is not None else x
    zi = zi_unit[:, :, None] * ext[0]
    fwd = _sosfilt_jit(sos, ext, zi)
    rev = fwd[::-1]
    zi_b = zi_unit[:, :, None] * rev[0]
    bwd = _sosfilt_jit(sos, rev, zi_b)
    y = bwd[::-1]
    if padlen > 0:
        y = y[padlen:-padlen]
    return y
