"""Pandas-level analysis API mirroring the reference's ``analysis`` module.

Every function here keeps the reference's signature and DataFrame
semantics (one 1-D signal per column, optional ``inplace``; reference:
src/muscle_synergies/analysis.py) while the numerics run through the
JAX array core in :mod:`muscle_synergies_tpu.ops` — so the same calls
users make on a laptop drive fused XLA computations on the accelerator.

Precision note: computations inherit JAX's active float width, except
the IIR filters (:func:`digital_filter`, :func:`linear_envelope`),
which always run in float64: composing a low cutoff's near-unit poles
over a long capture through the associative scan loses tens of percent
of relative accuracy in float32.  With ``jax_enable_x64`` every result
matches scipy/sklearn at float64.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Union

import jax
import numpy as np
from ._optional import pandas

from .ops import emg as _emg

__all__ = [
    "zero_center",
    "digital_filter",
    "linear_envelope",
    "rms",
    "normalize",
    "subsample",
    "time_normalize",
    "fft_spectrum",
    "vaf",
]

_NUMPY_ARRAY_LIKE = Any


def _recreate_signal(
    signal_df: pandas.DataFrame,
    inplace: bool = False,
    with_array: Optional[_NUMPY_ARRAY_LIKE] = None,
) -> pandas.DataFrame:
    """Return ``signal_df`` itself (inplace) or a copy, optionally refilled."""
    if not inplace:
        signal_df = pandas.DataFrame(signal_df, copy=True)
    if with_array is not None:
        signal_df[:] = np.asarray(with_array)
    return signal_df


def zero_center(
    signal_df: pandas.DataFrame, inplace: bool = False
) -> pandas.DataFrame:
    """Subtract each column's mean from it."""
    arr = _emg.zero_center(signal_df.to_numpy())
    return _recreate_signal(signal_df, inplace, arr)


def digital_filter(
    signal_df: pandas.DataFrame,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: int,
    order: int,
    filter_type: str = "butter",
    band_type: str = "lowpass",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    inplace: bool = False,
    padtype: Optional[str] = "odd",
) -> pandas.DataFrame:
    """Apply a Butterworth/Chebyshev filter to each column.

    ``zero_lag=True`` applies the filter forward and backward
    (zero-phase); otherwise one causal pass.  ``cheby_param`` is the
    passband ripple (cheby1) or stopband attenuation (cheby2) in dB.
    ``padtype`` selects the zero-lag edge extension
    (``"odd"``/``"even"``/``"constant"``/``None``, scipy semantics).
    """
    if filter_type not in {"butter", "cheby1", "cheby2"}:
        raise ValueError("filter type not understood.")
    with jax.enable_x64(True):
        arr = _emg.digital_filter(
            signal_df.to_numpy(),
        critical_freqs=critical_freqs,
        sampling_frequency=sampling_frequency,
        order=order,
        filter_type=filter_type,
        band_type=band_type,
        zero_lag=zero_lag,
        cheby_param=cheby_param,
            padtype=padtype,
        )
    return _recreate_signal(signal_df, inplace, arr)


def linear_envelope(
    signal_df: pandas.DataFrame,
    critical_freqs: Union[float, Sequence[float]],
    sampling_frequency: int,
    order: int,
    filter_type: str = "butter",
    zero_lag: bool = True,
    cheby_param: Optional[float] = None,
    zero_center_: bool = True,
    inplace: bool = False,
) -> pandas.DataFrame:
    """Linear envelope: (zero-center) -> rectify -> low-pass filter."""
    with jax.enable_x64(True):
        arr = _emg.linear_envelope(
            signal_df.to_numpy(),
            critical_freqs=critical_freqs,
            sampling_frequency=sampling_frequency,
            order=order,
            filter_type=filter_type,
            zero_lag=zero_lag,
            cheby_param=cheby_param,
            zero_center_=zero_center_,
        )
    return _recreate_signal(signal_df, inplace, arr)


def rms(
    signal_df: pandas.DataFrame,
    window_size: Union[int, float],
    inplace: bool = False,
    sampling_frequency: Optional[int] = None,
) -> pandas.DataFrame:
    """Moving-window RMS with stride 1 and same-length output.

    ``window_size`` counts samples, or seconds when
    ``sampling_frequency`` is given (``round(size * fs)`` samples).
    """
    arr = _emg.moving_rms(
        signal_df.to_numpy(),
        window_size=window_size,
        sampling_frequency=sampling_frequency,
    )
    return _recreate_signal(signal_df, inplace, arr)


def normalize(
    signal_df: pandas.DataFrame, inplace: bool = False
) -> pandas.DataFrame:
    """Divide each column by its maximum absolute value."""
    arr = _emg.normalize(signal_df.to_numpy())
    return _recreate_signal(signal_df, inplace, arr)


def subsample(
    signal_df: pandas.DataFrame, keep_every: Optional[int] = None
) -> pandas.DataFrame:
    """Keep every ``keep_every``-th row.

    Implements the reference's *documented* decimation semantics; the
    reference code (analysis.py:548) actually head-slices, contradicting
    its own docstring.

    Example:
        >>> import pandas
        >>> subsample(pandas.DataFrame({"m": range(6)}), 2)["m"].tolist()
        [0, 2, 4]
    """
    if keep_every is None:
        return signal_df.iloc[:]
    return signal_df.iloc[::keep_every]


def time_normalize(
    signal_df: pandas.DataFrame,
    reduce_to: int,
    kind: Optional[Union[int, str]] = "linear",
    fill_value="extrapolate",
) -> pandas.DataFrame:
    """Resample each column onto ``reduce_to`` points over [0, 1].

    Linear interpolation runs through the JAX core; other ``kind``
    values fall back to :func:`scipy.interpolate.interp1d` on host.
    """
    if kind == "linear":
        arr = np.asarray(_emg.time_normalize(signal_df.to_numpy(), reduce_to))
    else:
        from scipy import interpolate

        n = signal_df.shape[0]
        interp = interpolate.interp1d(
            np.linspace(0, 1, n),
            signal_df.to_numpy(),
            axis=0,
            copy=False,
            kind=kind,
            fill_value=fill_value,
        )
        arr = interp(np.linspace(0, 1, reduce_to))
    index = np.linspace(0, 1, reduce_to)
    return pandas.DataFrame(arr, index=index, columns=signal_df.columns)


def fft_spectrum(
    signal_df: pandas.DataFrame, sampling_frequency: int
) -> pandas.DataFrame:
    """Amplitude spectrum at positive frequencies (index = frequency)."""
    signal_df = pandas.DataFrame(signal_df)
    freqs, ampl = _emg.fft_spectrum(signal_df.to_numpy(), sampling_frequency)
    return pandas.DataFrame(
        np.asarray(ampl), index=freqs, columns=signal_df.columns
    )


def vaf(
    original_df: pandas.DataFrame,
    transformed_signal: Optional[_NUMPY_ARRAY_LIKE] = None,
    components: Optional[_NUMPY_ARRAY_LIKE] = None,
    reconstructed_signal: Optional[_NUMPY_ARRAY_LIKE] = None,
) -> pandas.DataFrame:
    """Variance accounted for by a reconstruction.

    ``VAF = 1 - ||x - x_r||^2 / ||x||^2`` (Frobenius norm), where
    ``x_r`` is ``reconstructed_signal`` or ``transformed_signal @
    components``.

    Returns:
        a 1-row DataFrame: column ``"All signals"`` holds the overall
        VAF and each remaining column the per-muscle VAF.
    """
    import jax.numpy as jnp

    x = jnp.asarray(original_df.to_numpy())
    if reconstructed_signal is None:
        reconstructed_signal = jnp.asarray(transformed_signal) @ jnp.asarray(
            components
        )
    overall, per_col = _emg.vaf(x, jnp.asarray(reconstructed_signal))
    labels = ["All signals"] + original_df.columns.tolist()
    # plain Python floats: uniform float64 columns regardless of the
    # device dtype (f32 runs otherwise mix f64/f32 across columns)
    values = [float(overall)] + [
        float(v) for v in np.ravel(np.asarray(per_col))
    ]
    return pandas.DataFrame({lbl: [val] for lbl, val in zip(labels, values)})


# Reference parity: the reference defines find_synergies in its
# analysis module (reference analysis.py:713), so reference-era
# `from ... analysis import find_synergies` imports must resolve here
# too.  The implementations live in models.select.
from .models.select import (  # noqa: E402  (re-export, placed last to
    NMFModel,                 # avoid import cycles at package load)
    SynergyRunResult,
    find_synergies,
)
from .models.cnmf import (  # noqa: E402  (beyond-reference companion:
    TimeVaryingSynergyResult,  # d'Avella-style time-varying synergies)
    find_time_varying_synergies,
)
