"""User-facing data model: device types, per-device data, whole captures.

Capability parity with the reference implementation:
- ``DeviceType``:     /root/reference/src/muscle_synergies/vicon_data/definitions.py:89-132
- ``DeviceData``:     /root/reference/src/muscle_synergies/vicon_data/user_data.py:664-772
- ``ViconNexusData``: /root/reference/src/muscle_synergies/vicon_data/user_data.py:42-301

Design differences from the reference: measurements live in a dense
float64 numpy array (``DeviceData.array``); the pandas ``DataFrame`` view
is built lazily for API compatibility.  ``ViconNexusData`` additionally
exposes :meth:`ViconNexusData.emg_array` and friends so the JAX pipeline
can grab device-ready arrays without a pandas round-trip.
"""

from __future__ import annotations

from enum import Enum
from typing import Optional, Sequence, Union

import numpy as np
from ._optional import pandas as pd

from .frames import FrameSubfr, FrameTracker, SamplingFreq


class SectionType(Enum):
    """Kind of a Vicon Nexus CSV section (the file holds exactly two).

    Vocabulary parity with the reference
    (vicon_data/definitions.py:23-42): ``FORCES_EMG`` is the section
    that opens with the word ``Devices`` (force plates + EMG at the
    fast rate), ``TRAJECTORIES`` holds marker kinematics at the slow
    rate.
    """

    FORCES_EMG = 1
    TRAJECTORIES = 2


class ForcePlateMeasurement(Enum):
    """The three vector measurements a force plate exports.

    A plate appears in the device-names line as three headers
    (``… - Force``, ``… - Moment``, ``… - CoP``), 3 columns each, which
    the ingest merges into one 9-column device (reference
    vicon_data/definitions.py:135-160).
    """

    FORCE = 1
    MOMENT = 2
    COP = 3


class DeviceType(Enum):
    """Kind of measurement device appearing in a Vicon Nexus capture."""

    FORCE_PLATE = 1
    EMG = 2
    TRAJECTORY_MARKER = 3

    @staticmethod
    def from_str(device_type: str) -> "DeviceType":
        """Parse a user-facing description such as ``"emg"`` or ``"fp"``.

        Accepted (case-insensitive): ``"emg"``; ``"force plate"``,
        ``"fp"``, ``"forcepl"``; ``"traj"``, ``"marker"``.
        """
        upper = device_type.upper()
        if upper == "EMG":
            return DeviceType.EMG
        if upper in {"FORCE PLATE", "FP", "FORCEPL"}:
            return DeviceType.FORCE_PLATE
        if upper in {"TRAJ", "MARKER"}:
            return DeviceType.TRAJECTORY_MARKER
        raise ValueError(f"device type not understood: {device_type}")

    def section_is_forces_emg(self) -> bool:
        return self in {DeviceType.EMG, DeviceType.FORCE_PLATE}

    def section_type(self) -> SectionType:
        """Section in which devices of this type occur."""
        if self.section_is_forces_emg():
            return SectionType.FORCES_EMG
        return SectionType.TRAJECTORIES


class DeviceData:
    """Measurements of one device plus its metadata and time index.

    Attributes:
        name: device name as it occurs in the CSV file.
        dev_type: the :class:`DeviceType`.
        units: physical unit of each column.
        coords: column labels (e.g. ``("Fx", ..., "Cz")``).
        array: ``(num_samples, num_cols)`` float64 array of measurements
            (missing cells are NaN).

    Indexing with a ``(frame, subframe)`` pair (or a slice of pairs)
    returns rows of the DataFrame at those time coordinates, which lets
    code address the same instant across devices with different rates.
    """

    def __init__(
        self,
        device_name: str,
        device_type: DeviceType,
        units: Sequence[str],
        frame_tracker: FrameTracker,
        dataframe: Optional[pd.DataFrame] = None,
        *,
        array: Optional[np.ndarray] = None,
        coords: Optional[Sequence[str]] = None,
    ):
        self.name = device_name
        self.dev_type = device_type
        self.units = tuple(units)
        self._frame_tracker = frame_tracker
        if dataframe is not None:
            self._df: Optional[pd.DataFrame] = dataframe
            self._array = dataframe.to_numpy(dtype=float)
            self.coords = tuple(dataframe.columns)
        else:
            if array is None or coords is None:
                raise ValueError("provide either dataframe or (array, coords)")
            self._df = None
            self._array = np.asarray(array, dtype=float)
            self.coords = tuple(coords)

    # -- array-first access (device pipeline) -----------------------------
    @property
    def array(self) -> np.ndarray:
        """Dense ``(num_samples, num_cols)`` float64 measurement block."""
        return self._array

    # -- pandas view (reference-compatible API) ---------------------------
    @property
    def df(self) -> pd.DataFrame:
        """Lazily-built DataFrame view with coords as column labels."""
        if self._df is None:
            self._df = pd.DataFrame(self._array, columns=list(self.coords))
        return self._df

    @property
    def sampling_frequency(self) -> int:
        return self._frame_tracker.sampling_frequency

    def time_seq(self) -> pd.Series:
        """Measurement times in seconds."""
        return self._frame_tracker.time_seq()

    def __getitem__(self, indices: Union[FrameSubfr, slice]) -> pd.DataFrame:
        if isinstance(indices, slice):
            return self.df.iloc[self.to_index(indices)]
        return self.df.iloc[self.to_index(*indices)]

    def to_framesubfr(self, index: Union[int, slice]) -> Union[FrameSubfr, slice]:
        """``(frame, subframe)`` pair (or slice of pairs) for array index."""
        return self._frame_tracker.to_framesubfr(index)

    def to_index(
        self,
        frame: Union[int, slice, FrameSubfr],
        subframe: Optional[int] = None,
    ) -> Union[int, slice]:
        """Array index (or slice) for a ``(frame, subframe)`` pair."""
        return self._frame_tracker.to_index(frame, subframe)

    def __eq__(self, other) -> bool:
        return (
            self.name == other.name
            and self.dev_type == other.dev_type
            and self.units == other.units
            and self.df.equals(other.df)
        )

    def __str__(self):
        return f'DeviceData("{self.name}")'

    def __repr__(self):
        return f"<{str(self)}>"


class ViconNexusData:
    """All devices of a capture, grouped by type.

    Args:
        forcepl: force-plate devices.
        emg: the single EMG device (all EMG channels are columns of it).
        traj: trajectory-marker devices.

    Devices can also be fetched by indexing with a :class:`DeviceType`
    or a string description (``data["emg"]``).
    """

    def __init__(
        self,
        forcepl: Sequence[DeviceData],
        emg: DeviceData,
        traj: Sequence[DeviceData],
        sampling_freq: Optional[SamplingFreq] = None,
    ):
        self.forcepl = list(forcepl)
        self.emg = emg
        self.traj = list(traj)
        self._sampling_freq = sampling_freq

    def __getitem__(
        self, device_type: Union[DeviceType, str]
    ) -> Union[DeviceData, Sequence[DeviceData]]:
        device_type = self._parse_device_type(device_type)
        if device_type is DeviceType.FORCE_PLATE:
            return self.forcepl
        if device_type is DeviceType.EMG:
            return self.emg
        if device_type is DeviceType.TRAJECTORY_MARKER:
            return self.traj
        raise KeyError(f"device type not understood: {device_type}")

    # -- array-first access (device pipeline) -----------------------------
    def emg_array(self) -> np.ndarray:
        """``(num_samples, num_muscles)`` EMG block."""
        return self.emg.array

    def forcepl_array(self) -> np.ndarray:
        """``(num_plates, num_samples, 9)`` stacked force-plate block."""
        return np.stack([dev.array for dev in self.forcepl])

    def traj_array(self) -> np.ndarray:
        """``(num_markers, num_frames, 3)`` stacked trajectory block."""
        return np.stack([dev.array for dev in self.traj])

    @property
    def sampling_freq(self) -> Optional[SamplingFreq]:
        return self._sampling_freq

    # -- multi-device column access ---------------------------------------
    def get_cols(
        self,
        device_type: Union[str, DeviceType],
        device_inds: Optional[Sequence[int]] = None,
        time=None,
        cols=None,
    ):
        """Fetch (a subset of) rows/columns across devices of one type.

        Args:
            device_type: target type, as enum or string description.
            device_inds: which devices of that type to include (all when
                ``None``; ignored for EMG, which is a single device).
            time: ``None`` for all rows, otherwise forwarded to
                ``DeviceData[time]`` (a ``(frame, subframe)`` pair or a
                slice of pairs).
            cols: ``None`` for all columns, otherwise forwarded to the
                DataFrame as ``df[cols]``.

        Returns:
            For EMG a single DataFrame/Series; otherwise a tuple with
            one entry per selected device.
        """

        def one(dev: DeviceData):
            frame = dev.df if time is None else dev[time]
            return frame if cols is None else frame[cols]

        device_type = self._parse_device_type(device_type)
        if device_type is DeviceType.EMG:
            return one(self.emg)

        devices = self[device_type]
        if device_inds is not None:
            devices = [devices[i] for i in device_inds]
        return tuple(one(dev) for dev in devices)

    def plot_cols(
        self,
        device_type: Union[str, DeviceType],
        col: str,
        device_inds: Optional[Sequence[int]] = None,
        time=None,
        labels: Optional[Sequence[str]] = None,
        show: bool = True,
        **all_plots_kwargs,
    ):
        """Plot one column across devices of a type against time."""
        import matplotlib.pyplot as plt

        fig, ax = plt.subplots()
        all_series = self.get_cols(
            device_type, device_inds=device_inds, time=time, cols=col
        )
        if self._parse_device_type(device_type) is DeviceType.EMG:
            all_series = (all_series,)
        if labels is None:
            labels = [None] * len(all_series)
        for series, label in zip(all_series, labels):
            ax.plot(self.time_seq(device_type), series, label=label, **all_plots_kwargs)
        if show:  # pragma: no cover - interactive path
            plt.show()
            return None
        return fig, ax

    # -- per-type delegation ----------------------------------------------
    def sampling_frequency(self, device_type: Union[str, DeviceType]) -> int:
        """Sampling rate (Hz) of devices of the given type."""
        return self._device_of_type(device_type).sampling_frequency

    def time_seq(self, device_type: Union[str, DeviceType]) -> pd.Series:
        """Measurement times in seconds for devices of the given type."""
        return self._device_of_type(device_type).time_seq()

    def to_framesubfr(
        self, device_type: Union[str, DeviceType], index: Union[int, slice]
    ) -> Union[FrameSubfr, slice]:
        return self._device_of_type(device_type).to_framesubfr(index)

    def to_index(
        self,
        device_type: Union[str, DeviceType],
        frame: Union[int, slice, FrameSubfr],
        subframe: Optional[int] = None,
    ) -> Union[int, slice]:
        return self._device_of_type(device_type).to_index(frame, subframe)

    def _device_of_type(self, device_type: Union[DeviceType, str]) -> DeviceData:
        if self._parse_device_type(device_type) is DeviceType.EMG:
            return self.emg
        return self[device_type][0]

    @staticmethod
    def _parse_device_type(device_type):
        try:
            return DeviceType.from_str(device_type)
        except AttributeError:
            return device_type

    # -- summaries ---------------------------------------------------------
    def __repr__(self):
        return "ViconNexusData(forcepl=[...], emg=<DeviceData>, traj=[...])"

    def describe(self) -> str:
        """Markdown-style one-glance summary of the loaded capture."""

        def amount(num: int, noun: str) -> str:
            return f"{num} {noun}{'' if num == 1 else 's'}"

        def listing(seq: Sequence) -> str:
            seq = list(seq)
            if len(seq) > 2:
                seq = [seq[0], "...", seq[-1]]
            return ", ".join(map(str, seq))

        return (
            "ViconNexusData:\n"
            f"+ emg: {amount(len(self.emg.coords), 'column')}\n"
            f"+ forcepl ({amount(len(self.forcepl), 'device')}): "
            f"{listing(self.forcepl)}\n"
            f"+ traj ({amount(len(self.traj), 'device')}): {listing(self.traj)}"
        )
