"""Sampling-rate vocabulary and frame/subframe index math.

A Vicon Nexus capture stores two streams at different rates: the
forces/EMG section (fast rate, e.g. 2000 Hz) and the trajectories
section (slow rate, e.g. 100 Hz).  Time is addressed with a shared
``(frame, subframe)`` coordinate: every trajectory sample is one frame
(subframe 0) while the fast stream has ``num_subframes`` samples per
frame.  Frames are 1-based and subframes 0-based.

Capability parity with the reference implementation:
- ``SamplingFreq``: /root/reference/src/muscle_synergies/vicon_data/definitions.py:163-199
- frame trackers:   /root/reference/src/muscle_synergies/vicon_data/user_data.py:483-661

Unlike the reference (scalar Python arithmetic), the conversion methods
here also accept numpy arrays so whole index vectors convert at once,
which is what the batched device pipeline uses to align streams.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import numpy as np
from ._optional import pandas as pd

FrameSubfr = Tuple[int, int]
"""Time expressed as a ``(frame, subframe)`` pair."""


@dataclass(frozen=True)
class SamplingFreq:
    """Sampling rates of the two sections plus the total frame count.

    Attributes:
        freq_forces_emg: sampling rate (Hz) of the forces/EMG section.
        freq_traj: sampling rate (Hz) of the trajectories section.
        num_frames: total number of (trajectory) frames in the capture.

    Example:
        >>> sf = SamplingFreq(freq_forces_emg=2000, freq_traj=100,
        ...                   num_frames=3)
        >>> sf.num_subframes
        20
    """

    freq_forces_emg: int
    freq_traj: int
    num_frames: int

    @property
    def num_subframes(self) -> int:
        """Fast samples per frame; the rate ratio, which must be integral."""
        ratio = self.freq_forces_emg / self.freq_traj
        if ratio != int(ratio):
            raise ValueError(
                "forces/EMG sampling frequency must be an integer multiple of "
                f"the trajectory one, got {self.freq_forces_emg}/{self.freq_traj}"
            )
        return int(ratio)


class FrameTracker(abc.ABC):
    """Convert array indices to/from ``(frame, subframe)`` for one section.

    The first data row of a section has index 0 and corresponds to frame
    1, subframe 0.  Concrete subclasses implement the conversion for the
    fast (forces/EMG) and slow (trajectory) sections.

    Example:
        >>> sf = SamplingFreq(freq_forces_emg=300, freq_traj=100,
        ...                   num_frames=2)
        >>> fast = ForcesEMGFrameTracker(sf)
        >>> fast.to_index((2, 1))
        4
        >>> fast.to_framesubfr(4)
        (2, 1)
        >>> TrajFrameTracker(sf).to_index((2, 0))
        1
    """

    def __init__(self, sampling_freq: SamplingFreq):
        self._sampling_freq = sampling_freq

    # -- basic properties -------------------------------------------------
    @property
    def num_frames(self) -> int:
        return self._sampling_freq.num_frames

    @property
    def num_subframes(self) -> int:
        return self._sampling_freq.num_subframes

    @property
    @abc.abstractmethod
    def sampling_frequency(self) -> int:
        """Sampling rate (Hz) of this section."""

    @property
    @abc.abstractmethod
    def final_index(self) -> int:
        """The highest valid array index."""

    # -- conversions ------------------------------------------------------
    def to_index(
        self,
        frame: Union[int, slice, FrameSubfr],
        subframe: Optional[int] = None,
    ) -> Union[int, slice]:
        """Array index for a ``(frame, subframe)`` pair (or slice of pairs).

        Raises:
            IndexError: if frame/subframe fall outside the valid range
                (frames are 1-based up to ``num_frames``; subframes are
                0-based below ``num_subframes``).
        """
        if subframe is None:
            if isinstance(frame, slice):
                return self._map_slice(frame, self._pair_to_index)
            frame, subframe = frame
        return self._pair_to_index((frame, subframe))

    def to_framesubfr(self, index: Union[int, slice]) -> Union[FrameSubfr, slice]:
        """``(frame, subframe)`` pair for an array index (or slice)."""
        if isinstance(index, slice):
            return self._map_slice(index, self._index_to_pair)
        return self._index_to_pair(index)

    def index_array(self, frames: np.ndarray, subframes: np.ndarray) -> np.ndarray:
        """Vectorized ``to_index`` over numpy arrays (no validation)."""
        return self._index_impl(np.asarray(frames), np.asarray(subframes))

    def time_seq(self) -> pd.Series:
        """Measurement times in seconds, one entry per array index."""
        period = 1.0 / self.sampling_frequency
        n = self.final_index + 1
        return pd.Series(period * np.arange(1, n + 1))

    # -- internals --------------------------------------------------------
    def _pair_to_index(self, framesubfr: FrameSubfr) -> int:
        self._validate_pair(framesubfr)
        frame, subframe = framesubfr
        return int(self._index_impl(frame, subframe))

    def _index_to_pair(self, index: int) -> FrameSubfr:
        self._validate_index(index)
        return self._pair_impl(index)

    @abc.abstractmethod
    def _index_impl(self, frame, subframe):
        """Index formula (vectorizable, no validation)."""

    @abc.abstractmethod
    def _pair_impl(self, index: int) -> FrameSubfr:
        """Inverse formula (no validation)."""

    def _validate_index(self, index: int):
        if not 0 <= index <= self.final_index:
            raise IndexError(
                f"index {index} out of bounds (max is {self.final_index})"
            )

    def _validate_pair(self, framesubfr: FrameSubfr):
        frame, subframe = framesubfr
        if not 1 <= frame <= self.num_frames:
            raise IndexError(f"frame {frame} is out of bounds")
        if not 0 <= subframe < self.num_subframes:
            raise IndexError(f"subframe {subframe} out of range")

    @staticmethod
    def _map_slice(slice_: slice, func) -> slice:
        def maybe(arg):
            return None if arg is None else func(arg)

        return slice(maybe(slice_.start), maybe(slice_.stop), maybe(slice_.step))


class ForcesEMGFrameTracker(FrameTracker):
    """Index math for the fast (forces/EMG) section."""

    @property
    def sampling_frequency(self) -> int:
        return self._sampling_freq.freq_forces_emg

    @property
    def final_index(self) -> int:
        return self.num_frames * self.num_subframes - 1

    def _index_impl(self, frame, subframe):
        return (frame - 1) * self.num_subframes + subframe

    def _pair_impl(self, index: int) -> FrameSubfr:
        return index // self.num_subframes + 1, index % self.num_subframes


class TrajFrameTracker(FrameTracker):
    """Index math for the slow (trajectories) section."""

    @property
    def sampling_frequency(self) -> int:
        return self._sampling_freq.freq_traj

    @property
    def final_index(self) -> int:
        return self.num_frames - 1

    def _index_impl(self, frame, subframe):
        del subframe  # every trajectory sample sits at subframe 0
        return frame - 1

    def _pair_impl(self, index: int) -> FrameSubfr:
        return index + 1, 0
