"""Module-path twin of the reference's ``muscle_synergies.analysis``.

The reference ships its analysis layer as an importable module
(reference src/muscle_synergies/analysis.py:33-914, re-exported through
__init__.py:5), so reference-era code does either of::

    from muscle_synergies.analysis import find_synergies
    import muscle_synergies.analysis as analysis

Both must resolve here too.  Every name re-exports the accelerated
implementation (:mod:`muscle_synergies_tpu.analysis` et al.); the
signatures and defaults are the reference's.
"""

from muscle_synergies_tpu import (
    SynergyRunResult,
    digital_filter,
    fft_spectrum,
    find_synergies,
    linear_envelope,
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

__all__ = (
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
    "SynergyRunResult",
)
