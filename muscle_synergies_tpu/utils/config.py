"""Declarative pipeline presets (hashable, jit-friendly).

The reference configures everything through per-call keyword arguments
(reference analysis.py:314-324, 718-719).  That API is preserved; this
module adds what the reference lacks (SURVEY §5 "config/flag system"):
a small frozen dataclass capturing a whole preprocessing + synergy
pipeline, so sweeps are declarative, serializable and usable as static
arguments to jitted entry points.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["FilterSpec", "PipelineConfig"]


@dataclass(frozen=True)
class FilterSpec:
    """An IIR filter design, as consumed by ``ops.filters.sos_design``."""

    order: int = 4
    critical_freqs: Tuple[float, ...] = (4.0,)
    filter_type: str = "butter"
    band_type: str = "lowpass"
    cheby_param: Optional[float] = None
    zero_lag: bool = True

    def design(self, sampling_frequency: float):
        from ..ops.filters import sos_design

        freqs = (
            self.critical_freqs[0]
            if len(self.critical_freqs) == 1
            else list(self.critical_freqs)
        )
        return sos_design(
            self.order,
            freqs,
            sampling_frequency,
            filter_type=self.filter_type,
            band_type=self.band_type,
            cheby_param=self.cheby_param,
        )


@dataclass(frozen=True)
class PipelineConfig:
    """A full EMG -> synergies pipeline, declaratively.

    Attributes:
        envelope: low-pass filter for the linear envelope (used when
            ``use_rms`` is False).
        use_rms / rms_window_s: moving-RMS smoothing instead of the
            filtered envelope, window in seconds.
        reduce_to: time-normalization target length (None to skip).
        amplitude_normalize: divide channels by their max abs value.
        min_rank / max_rank: VAF rank-sweep range.
        solver / max_iter / tol: NMF solver settings.
        solver_impl: batched-solver implementation for dataset-scale
            runs — ``"xla"`` (any backend), ``"pallas"`` (the fused
            Triton kernels, GPU only) or ``"auto"`` (the default: the
            kernel on a GPU where the fit has one, xla elsewhere; see
            :func:`muscle_synergies_tpu.utils.platform.resolve_impl`).
        inner_iter: accelerated-MU inner repetitions per outer
            iteration (1 = sklearn-exact plain MU).
    """

    envelope: FilterSpec = FilterSpec()
    zero_center: bool = True
    use_rms: bool = False
    rms_window_s: float = 0.5
    reduce_to: Optional[int] = 200
    amplitude_normalize: bool = True
    min_rank: int = 1
    max_rank: int = 4
    solver: str = "cd"
    beta_loss: str = "frobenius"
    max_iter: int = 100_000
    tol: float = 1e-6
    solver_impl: str = "auto"
    inner_iter: int = 1

    # -- execution ---------------------------------------------------------
    def preprocess(self, x, sampling_frequency: float):
        """Apply the configured preprocessing chain to ``(N, L)`` data."""
        import jax.numpy as jnp

        from ..ops import emg as _emg

        x = jnp.asarray(x)
        if self.use_rms:
            if self.zero_center:
                x = _emg.zero_center(x)
            x = _emg.moving_rms(
                x, self.rms_window_s, sampling_frequency=sampling_frequency
            )
        else:
            x = _emg.linear_envelope(
                x,
                critical_freqs=(
                    self.envelope.critical_freqs[0]
                    if len(self.envelope.critical_freqs) == 1
                    else list(self.envelope.critical_freqs)
                ),
                sampling_frequency=sampling_frequency,
                order=self.envelope.order,
                filter_type=self.envelope.filter_type,
                zero_lag=self.envelope.zero_lag,
                cheby_param=self.envelope.cheby_param,
                zero_center_=self.zero_center,
            )
        if self.reduce_to is not None:
            x = _emg.time_normalize(x, self.reduce_to)
        if self.amplitude_normalize:
            x = _emg.normalize(jnp.abs(x))
        return x

    def find_synergies(self, processed_emg_df, **overrides):
        """Run the configured rank sweep on an already-processed frame."""
        from ..models import find_synergies

        kwargs = dict(
            max_iter=self.max_iter, tol=self.tol, solver=self.solver,
            beta_loss=self.beta_loss,
        )
        kwargs.update(overrides)
        return find_synergies(
            processed_emg_df, self.min_rank, self.max_rank, **kwargs
        )

    # -- serialization -----------------------------------------------------
    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "PipelineConfig":
        raw = json.loads(text)
        raw["envelope"] = FilterSpec(
            **{**raw["envelope"],
               "critical_freqs": tuple(raw["envelope"]["critical_freqs"])}
        )
        return cls(**raw)
