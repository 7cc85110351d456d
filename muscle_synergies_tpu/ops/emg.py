"""EMG preprocessing as pure JAX array transforms.

Array-level core of the analysis layer: every function takes a
``(num_samples, num_channels)`` block (time major), is jit-friendly and
vmaps over leading trial axes, so whole multi-trial datasets preprocess
in one fused XLA computation on the device.

Capability parity with the reference analysis functions
(reference: src/muscle_synergies/analysis.py):

- :func:`zero_center`      <- analysis.py:230-249
- :func:`rectify`          (the ``abs`` step of analysis.py:252-311)
- :func:`linear_envelope`  <- analysis.py:252-311
- :func:`moving_rms`       <- analysis.py:435-507
- :func:`normalize`        <- analysis.py:510-525
- :func:`subsample`        <- analysis.py:528-548 (documented
  behavior: keep every i-th row; the reference implementation has a
  latent bug making it a head-slice — this framework implements the
  documented decimation)
- :func:`time_normalize`   <- analysis.py:551-594
- :func:`fft_spectrum`     <- analysis.py:165-198
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from .filters import sos_design, sosfiltfilt, sosfilt

__all__ = [
    "zero_center",
    "rectify",
    "digital_filter",
    "linear_envelope",
    "moving_rms",
    "normalize",
    "subsample",
    "time_normalize",
    "fft_spectrum",
]


def zero_center(x: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Subtract each channel's mean (time axis defaults to 0).

    Example:
        >>> import numpy as np
        >>> np.asarray(zero_center(np.array([[1.0], [3.0]]))).ravel().tolist()
        [-1.0, 1.0]
    """
    x = jnp.asarray(x)
    return x - jnp.mean(x, axis=axis, keepdims=True)


def rectify(x: jnp.ndarray) -> jnp.ndarray:
    """Full-wave rectification.

    Example:
        >>> import numpy as np
        >>> np.asarray(rectify(np.array([-2.0, 0.5]))).tolist()
        [2.0, 0.5]
    """
    return jnp.abs(x)


def digital_filter(
    x: jnp.ndarray,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    order: int,
    filter_type: str = "butter",
    band_type: str = "lowpass",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    padtype: Optional[str] = "odd",
) -> jnp.ndarray:
    """Butterworth/Chebyshev filtering of a ``(N, C)`` block.

    ``zero_lag=True`` applies the filter forward and backward
    (zero-phase, scipy ``sosfiltfilt`` semantics); otherwise a single
    causal pass.  ``padtype`` selects the zero-lag edge extension
    (``"odd"``/``"even"``/``"constant"``/``None``, scipy semantics);
    ignored for causal filtering.
    """
    sos = sos_design(
        order,
        critical_freqs,
        sampling_frequency,
        filter_type=filter_type,
        band_type=band_type,
        cheby_param=cheby_param,
    )
    if zero_lag:
        return sosfiltfilt(sos, x, padtype=padtype)
    return sosfilt(sos, x)


def linear_envelope(
    x: jnp.ndarray,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: float,
    order: int,
    filter_type: str = "butter",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    zero_center_: bool = True,
) -> jnp.ndarray:
    """Linear envelope: (zero-center) -> rectify -> low-pass filter."""
    if zero_center_:
        x = zero_center(x)
    return digital_filter(
        rectify(x),
        critical_freqs=critical_freqs,
        sampling_frequency=sampling_frequency,
        order=order,
        filter_type=filter_type,
        band_type="lowpass",
        zero_lag=zero_lag,
        cheby_param=cheby_param,
    )


def _two_sum(a, b):
    """Knuth's error-free transformation: a + b = s + e exactly."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _df_add(x, y):
    """Double-float addition for the compensated scan (hi, lo) pairs."""
    s, e = _two_sum(x[0], y[0])
    e = e + x[1] + y[1]
    return _two_sum(s, e)


@functools.partial(jax.jit, static_argnames=("window",))
def _moving_rms_jit(x, window):
    # Box-kernel "same" convolution as a cumulative-sum difference:
    # O(N) instead of O(N * window), and it sidesteps XLA's direct
    # convolution lowering of 1000-tap kernels.  Window placement
    # matches np.convolve(sq, ones(w)/w, "same") exactly: output i
    # averages sq[i - w//2 : i + (w-1)//2 + 1],
    # zero-padded at the edges (the reference's edge behavior,
    # reference analysis.py:474-491).
    #
    # The running sum is kept in COMPENSATED (double-float) form: a
    # plain f32 cumsum grows to the signal's total energy, and the
    # windowed difference of two nearby ~1e7 totals cancels to zero —
    # a quiet tail after a large transient reads exactly 0 RMS.  The
    # (hi, lo) pair carries ~2x the mantissa, so window sums stay
    # accurate relative to the window, not the whole-signal energy.
    n = x.shape[0]
    square = x * x
    cs_hi, cs_lo = jax.lax.associative_scan(
        _df_add, (square, jnp.zeros_like(square)), axis=0
    )
    zero = jnp.zeros((1, x.shape[1]), x.dtype)
    cs_hi = jnp.concatenate([zero, cs_hi])
    cs_lo = jnp.concatenate([zero, cs_lo])
    idx = jnp.arange(n)
    lo = jnp.clip(idx - window // 2, 0, n)
    hi = jnp.clip(idx + (window - 1) // 2 + 1, 0, n)
    win_sum = (cs_hi[hi] - cs_hi[lo]) + (cs_lo[hi] - cs_lo[lo])
    mean_sq = win_sum / window
    # rounding can leave tiny negatives where the true sum is ~0
    return jnp.sqrt(jnp.maximum(mean_sq, 0.0))


def moving_rms(
    x: jnp.ndarray,
    window_size: Union[int, float],
    sampling_frequency: Optional[float] = None,
) -> jnp.ndarray:
    """Moving-window RMS, stride 1, same-length output.

    Matches the reference semantics exactly: square, convolve with a
    length-``window`` averaging kernel in ``"same"`` mode (zero-padded
    edges, so edge windows are divided by the full window size), then
    square root.

    Args:
        window_size: window in samples, or in seconds when
            ``sampling_frequency`` is given (``round(size * fs)``).
    """
    if sampling_frequency is not None:
        window = int(round(window_size * sampling_frequency))
    else:
        window = int(window_size)
    if window < 1:
        raise ValueError(f"window must contain at least one sample, got {window}")
    x2 = jnp.asarray(x)
    if window > x2.shape[0]:
        # np.convolve 'same' would return a window-length (not
        # signal-length) array here, which no downstream consumer can
        # use; fail loudly instead of silently truncating
        raise ValueError(
            f"window ({window} samples) is longer than the signal "
            f"({x2.shape[0]} samples)"
        )
    squeeze = x2.ndim == 1
    if squeeze:
        x2 = x2[:, None]
    out = _moving_rms_jit(x2, window)
    return out[:, 0] if squeeze else out


def normalize(x: jnp.ndarray, axis: int = 0) -> jnp.ndarray:
    """Divide each channel by its maximum absolute value.

    An all-zero channel (dead electrode) stays zero — a deliberate
    deviation from the reference, whose 0/0 would propagate NaN into
    every downstream step — matching ``normalize_batch``'s guard.
    """
    x = jnp.asarray(x)
    denom = jnp.max(jnp.abs(x), axis=axis, keepdims=True)
    return x / jnp.where(denom == 0, 1.0, denom)


def subsample(x: jnp.ndarray, keep_every: Optional[int] = None) -> jnp.ndarray:
    """Keep every ``keep_every``-th sample along the time axis.

    Note: this implements the reference's *documented* behavior
    (decimation).  The reference code (analysis.py:548) slices
    ``iloc[0:keep_every]`` — a head-slice — which its own docstring
    contradicts; the decimation semantics are kept here.
    """
    if keep_every is None:
        return jnp.asarray(x)
    return jnp.asarray(x)[::keep_every]


@functools.partial(jax.jit, static_argnames=("reduce_to",))
def _time_normalize_jit(x, reduce_to):
    n = x.shape[0]
    src = jnp.linspace(0.0, 1.0, n)
    dst = jnp.linspace(0.0, 1.0, reduce_to)

    def per_channel(col):
        return jnp.interp(dst, src, col)

    return jax.vmap(per_channel, in_axes=1, out_axes=1)(x)


def time_normalize(x: jnp.ndarray, reduce_to: int) -> jnp.ndarray:
    """Linearly resample the block onto ``reduce_to`` points in [0, 1].

    The output time base is ``linspace(0, 1, reduce_to)`` (normalized
    gait-cycle time).  Only linear interpolation is supported in the
    array core; the pandas layer falls back to scipy for other kinds.
    """
    x2 = jnp.asarray(x)
    squeeze = x2.ndim == 1
    if squeeze:
        x2 = x2[:, None]
    out = _time_normalize_jit(x2, reduce_to)
    return out[:, 0] if squeeze else out


def fft_spectrum(x: jnp.ndarray, sampling_frequency: float):
    """Amplitude spectrum at strictly positive frequencies.

    Returns:
        ``(freqs, amplitudes)``: frequencies in the units of
        ``sampling_frequency`` and ``|FFT|`` per channel.
    """
    x = jnp.asarray(x)
    n = x.shape[0]
    freqs = np.fft.fftfreq(n, d=1.0 / sampling_frequency)
    positive = freqs > 0
    spectrum = jnp.abs(jnp.fft.fft(x, axis=0)[positive])
    return freqs[positive], spectrum


@jax.jit
def vaf(x: jnp.ndarray, reconstruction: jnp.ndarray):
    """Variance accounted for by ``reconstruction`` of ``x``.

    ``VAF = 1 - ||x - x_r||^2 / ||x||^2`` (Frobenius), computed on
    device (reference analysis.py:612-652 computes the same statistic
    on host numpy).

    Returns:
        ``(overall, per_channel)`` — a scalar and a ``(L,)`` vector
        for an ``(N, L)`` signal.
    """
    err = x - reconstruction
    overall = 1.0 - jnp.sum(err * err) / jnp.sum(x * x)
    per_channel = 1.0 - jnp.sum(err * err, axis=0) / jnp.sum(x * x, axis=0)
    return overall, per_channel
