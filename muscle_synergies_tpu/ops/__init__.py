"""Array-level signal-processing ops (pure JAX, jit/vmap-ready)."""

from .emg import (
    digital_filter,
    fft_spectrum,
    linear_envelope,
    moving_rms,
    normalize,
    rectify,
    subsample,
    time_normalize,
    zero_center,
)
from .batched import (
    linear_envelope_batch,
    moving_rms_batch,
    normalize_batch,
    time_normalize_batch,
    zero_center_batch,
)
from .filters import default_padlen, sos_design, sosfilt, sosfilt_zi, sosfiltfilt
from .kinematics import (
    cop_path_length,
    finite_difference,
    grf_impulse,
    loading_rate,
    marker_acceleration,
    marker_speed,
    marker_velocity,
    upsample_to_fast,
)

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
    "sos_design",
    "sosfilt",
    "sosfilt_zi",
    "sosfiltfilt",
    "default_padlen",
    "finite_difference",
    "marker_velocity",
    "marker_acceleration",
    "marker_speed",
    "upsample_to_fast",
    "cop_path_length",
    "grf_impulse",
    "loading_rate",
    "zero_center_batch",
    "moving_rms_batch",
    "time_normalize_batch",
    "normalize_batch",
    "linear_envelope_batch",
]
