"""Drop-in compatibility facade for the reference ``muscle_synergies``.

Code written against the reference package
(reference src/muscle_synergies/__init__.py exports these exact names)
keeps working unchanged on top of the accelerated framework:

    from muscle_synergies import load_vicon_file, find_synergies

Everything re-exports from :mod:`muscle_synergies_tpu`.

One deliberate behavioral divergence: ``subsample`` implements the
reference's *documented* semantics (keep every i-th row).  The
reference's code head-slices instead (reference analysis.py:548
contradicts its own docstring); scripts relying on that bug will see
decimation here.
"""

from muscle_synergies_tpu import (
    DeviceData,
    DeviceType,
    SynergyRunResult,
    ViconNexusData,
    digital_filter,
    fft_spectrum,
    find_synergies,
    linear_envelope,
    load_vicon_file,
    normalize,
    plot_fft,
    plot_signal,
    rms,
    subsample,
    synergy_heatmap,
    time_normalize,
    vaf,
    zero_center,
)
from muscle_synergies_tpu.frames import FrameSubfr

from . import analysis, vicon_data  # noqa: E402  (compat submodules)

__version__ = "0.1.0"

__all__ = (
    "load_vicon_file",
    "plot_signal",
    "synergy_heatmap",
    "plot_fft",
    "fft_spectrum",
    "zero_center",
    "linear_envelope",
    "digital_filter",
    "rms",
    "normalize",
    "subsample",
    "time_normalize",
    "vaf",
    "find_synergies",
)
