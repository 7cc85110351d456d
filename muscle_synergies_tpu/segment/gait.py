"""Gait-phase segmentation from force-plate ground reactions.

Capability parity with the reference's experiment module
(reference project/segment.py):

- :class:`Phase` / :class:`Trecho` / :class:`Cycle` vocabulary
  (segment.py:21-88): four phases of a lateral-walk step (wide double
  support DAA, right-leg-only AS, narrow double support DAE, swing BL),
  four passes over the plates, two cycles per pass;
- :func:`reactions` (segment.py:118-121): the (left, right) vertical
  ground-reaction series;
- :func:`transition_indices` (segment.py:667-755): sample indices where
  the number of legs on the ground changes, debounced by requiring
  ``min_phase_size`` consecutive samples of the new support state;
- :class:`Segmenter` (segment.py:124-298): maps
  ``(trecho, cycle, phase)`` queries to ``(frame, subframe)`` slices;
- :class:`SegmentPlotter` (segment.py:301-664): shades segments over
  signal plots.

The transition scan is vectorized: support-state validity over a
debounce window is a cumulative-sum trick and each alternating search
is a ``searchsorted`` into the precomputed valid-index arrays — no
per-sample Python loop.
"""

from __future__ import annotations

from collections import OrderedDict
from enum import Enum, auto
from typing import List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
from .._optional import pandas as pd

from ..data import ViconNexusData
from ..frames import FrameSubfr

__all__ = [
    "Phase",
    "Trecho",
    "Cycle",
    "Segments",
    "reactions",
    "transition_indices",
    "Segmenter",
    "SegmentPlotter",
]


class Phase(Enum):
    """The 4 phases of a lateral-walk step (right-leg-centric terms).

    DAA: wide double support.  AS: right leg only.  DAE: narrow double
    support.  BL: swing (left leg only).
    """

    DAA = "DAA"
    AS = "AS"
    DAE = "DAE"
    BL = "BL"

    @staticmethod
    def from_str(phase: str) -> "Phase":
        return Phase[phase.upper()]


class Trecho(Enum):
    """The 4 passes over the force plates during a trial.

    Passes 1 and 3 run right-to-left, passes 2 and 4 left-to-right.
    Each contains 2 full cycles (8 phases).
    """

    FIRST = auto()
    SECOND = auto()
    THIRD = auto()
    FOURTH = auto()


class Cycle(Enum):
    """Each of the 2 step cycles within one pass."""

    FIRST = auto()
    SECOND = auto()


Segments = Mapping[Trecho, Mapping[Cycle, "OrderedDict[Phase, slice]"]]
"""``{trecho: {cycle: {phase: slice((frame, subfr), (frame, subfr))}}}``.

The phase dict preserves the order in which phases occur in the cycle.
"""

PhaseRef = Union[Phase, int, str]


def reactions(vicon_nexus_data: ViconNexusData) -> Tuple[pd.Series, pd.Series]:
    """(left, right) vertical ground reactions of the two force plates."""
    left_fp, right_fp = vicon_nexus_data.forcepl[:2]
    return left_fp.df["Fz"], right_fp.df["Fz"]


def _windowed_all(flags: np.ndarray, window: int) -> np.ndarray:
    """``out[i] = flags[i:i+window].all()``, requiring a FULL window.

    Positions whose window would run past the signal end are False.
    This is a deliberate deviation from the reference's scan: its numpy
    slice ``correct_activation[ind:ind+window].all()`` (reference
    segment.py:730) truncates at the array end, so an all-active run
    *shorter* than ``window`` in the final samples would count as a
    debounced stretch there — e.g. two samples of sensor ringing at
    the very end of a capture.  Here the debounce contract demands the
    full ``window`` consecutive samples everywhere (pinned by
    ``tests/test_segment.py::TestRegressionFixes::
    test_tail_glitch_not_accepted_as_debounced``).
    """
    n = len(flags)
    out = np.zeros(n, dtype=bool)
    m = n - window + 1
    if m > 0:
        cs = np.concatenate([[0], np.cumsum(flags.astype(np.int64))])
        out[:m] = (cs[window:] - cs[:m]) == window
    return out


def transition_indices(
    left_reaction,
    right_reaction,
    min_phase_size: int = 10,
    num_segments: int = 40,
) -> List[int]:
    """Indices where the number of active legs changes (debounced).

    Alternates between searching for a stretch with exactly one active
    leg and one with both active, each stretch required to persist for
    ``min_phase_size`` consecutive samples.  The first returned index
    marks the start of the signal's single-support lead-in; every
    subsequent one marks a support-state change.

    Args:
        num_segments: how many transitions to find; ``0`` finds as many
            as possible.

    Raises:
        ValueError: if ``num_segments > 0`` transitions cannot be found
            before the signal ends (try lowering ``min_phase_size``).

    Example:
        >>> left = np.full(60, -100.0)
        >>> right = np.concatenate([np.zeros(30), np.full(30, -50.0)])
        >>> transition_indices(left, right, min_phase_size=10,
        ...                    num_segments=2)
        [0, 30]
    """
    left = np.asarray(left_reaction)
    right = np.asarray(right_reaction)
    one_leg = np.logical_xor(left != 0, right != 0)
    two_legs = np.logical_and(left != 0, right != 0)

    valid = {
        1: np.flatnonzero(_windowed_all(one_leg, min_phase_size)),
        2: np.flatnonzero(_windowed_all(two_legs, min_phase_size)),
    }

    index_seq: List[int] = []
    start = 0
    legs = 1
    while num_segments == 0 or len(index_seq) < num_segments:
        candidates = valid[legs]
        pos = np.searchsorted(candidates, start)
        if pos == len(candidates):
            if num_segments == 0:
                return index_seq
            raise ValueError(
                f"no phase found with {min_phase_size} adjacent measurements "
                f"with {legs} leg(s) with a nonzero reaction "
                f"(found {len(index_seq)}/{num_segments} transitions)"
            )
        start = int(candidates[pos])
        index_seq.append(start)
        legs = 2 if legs == 1 else 1
    return index_seq


class Segmenter:
    """Parse ground reactions into trechos/cycles/phases and query them.

    The reference protocol is 4 passes (trechos) of 2 cycles each
    (reference segment.py:906-917); ``n_trechos`` / ``n_cycles``
    generalize it to any trial layout with the same alternating
    support-state grammar (lead-in, then per pass: 4 phases per cycle
    plus a closing transition, separated by single-support gaps).  With
    the default counts, trechos and cycles are keyed by the
    :class:`Trecho` / :class:`Cycle` enums; with custom counts they are
    keyed by 1-based integers.

    Args:
        data: the loaded capture (uses the first two force plates).
        min_phase_size: debounce window for support-state changes.
        n_trechos: number of passes over the plates.
        n_cycles: number of step cycles within each pass.
    """

    def __init__(
        self,
        data: ViconNexusData,
        min_phase_size: int = 10,
        n_trechos: int = 4,
        n_cycles: int = 2,
    ):
        if n_trechos < 1 or n_cycles < 1:
            raise ValueError("n_trechos and n_cycles must be at least 1")
        self._data = data
        self._n_trechos = n_trechos
        self._n_cycles = n_cycles
        self._trecho_keys = (
            tuple(Trecho) if n_trechos == 4 else tuple(range(1, n_trechos + 1))
        )
        self._cycle_keys = (
            tuple(Cycle) if n_cycles == 2 else tuple(range(1, n_cycles + 1))
        )
        left, right = reactions(data)
        self._left = np.asarray(left)
        self._right = np.asarray(right)
        transitions = transition_indices(
            self._left,
            self._right,
            min_phase_size=min_phase_size,
            num_segments=n_trechos * (4 * n_cycles + 2),
        )
        self._segments = self._organize(transitions)

    # -- public API --------------------------------------------------------
    @property
    def segments(self) -> Segments:
        return self._segments

    def ith_phase(self, trecho: Union[Trecho, int], i: int) -> Phase:
        """The i-th (1-based) phase of cycles in a given trecho."""
        if i not in range(1, 5):
            raise IndexError("i should be a number between 1 and 4")
        trecho = self._parse_trecho(trecho)
        phases = tuple(self._segments[trecho][self._cycle_keys[0]].keys())
        return phases[i - 1]

    def get_times_of(
        self,
        trecho,
        cycle: Optional[Union[Cycle, int]] = None,
        phase: Optional[PhaseRef] = None,
    ) -> slice:
        """``(frame, subframe)`` slice of a trecho / cycle / phase.

        ``trecho`` may also be a ``(trecho, cycle[, phase])`` tuple, in
        which case the other arguments must be omitted.  Integer
        arguments are 1-based; a phase may be named (``"BL"``) or given
        by its position in the cycle.

        Returns:
            a ``slice`` whose ``start``/``stop`` are ``(frame,
            subframe)`` pairs, directly usable to index
            :class:`~muscle_synergies_tpu.data.DeviceData`.
        """
        trecho, cycle, phase = self._parse_args(trecho, cycle, phase)
        seg = self._segments[trecho]
        if phase is not None:
            return seg[cycle][phase]
        if cycle is not None:
            phases = list(seg[cycle].values())
            return slice(phases[0].start, phases[-1].stop)
        first = list(seg[self._cycle_keys[0]].values())
        last = list(seg[self._cycle_keys[-1]].values())
        return slice(first[0].start, last[-1].stop)

    # -- argument parsing --------------------------------------------------
    def _parse_args(self, trecho, cycle, phase_ref):
        extras_given = cycle is not None or phase_ref is not None
        if isinstance(trecho, tuple):
            if extras_given:
                raise ValueError(
                    "the optional arguments should be omitted if a "
                    "(trecho, cycle, phase) tuple is given"
                )
            if len(trecho) == 3:
                trecho, cycle, phase_ref = trecho
            elif len(trecho) == 2:
                trecho, cycle = trecho
            else:
                raise ValueError("expected (trecho, cycle[, phase]) tuple")
        # validated AFTER tuple unpacking so (trecho, None, phase) gets
        # the documented error rather than a KeyError downstream
        if phase_ref is not None and cycle is None:
            raise ValueError("if a phase is given, a cycle should also be")
        trecho = self._parse_trecho(trecho)
        cycle = self._parse_cycle(cycle)
        phase = self._parse_phase(trecho, phase_ref)
        return trecho, cycle, phase

    def _parse_trecho(self, trecho):
        if isinstance(trecho, Trecho):
            if self._n_trechos == 4:
                return trecho
            trecho = trecho.value  # enum ordinal -> 1-based int
        if not 1 <= trecho <= self._n_trechos:
            raise IndexError(
                f"trecho must be between 1 and {self._n_trechos}, got {trecho}"
            )
        return self._trecho_keys[trecho - 1]

    def _parse_cycle(self, cycle):
        if cycle is None:
            return None
        if isinstance(cycle, Cycle):
            if self._n_cycles == 2:
                return cycle
            cycle = cycle.value
        if not 1 <= cycle <= self._n_cycles:
            raise IndexError(
                f"cycle must be between 1 and {self._n_cycles}, got {cycle}"
            )
        return self._cycle_keys[cycle - 1]

    def _parse_phase(self, trecho: Trecho, phase_ref) -> Optional[Phase]:
        if phase_ref is None or isinstance(phase_ref, Phase):
            return phase_ref
        if isinstance(phase_ref, str):
            return Phase.from_str(phase_ref)
        return self.ith_phase(trecho, phase_ref)

    # -- segmentation ------------------------------------------------------
    def _to_framesubfr(self, index: int) -> FrameSubfr:
        return self._data.forcepl[0].to_framesubfr(index)

    def _single_leg_phase(self, ind: int) -> Phase:
        """BL if only the left plate is loaded at ``ind``, else AS."""
        left_on = self._left[ind] != 0
        right_on = self._right[ind] != 0
        if left_on == right_on:
            raise ValueError(
                "expected index corresponding to a phase in which there is "
                "ground reaction for exactly one leg."
            )
        return Phase.BL if left_on else Phase.AS

    def _phase_order(self, second_phase_ind: int, ordinal: int) -> List[Phase]:
        """Order of phases in the cycles of the ``ordinal``-th pass.

        Odd passes (1st, 3rd, ...) run right-to-left and start wide
        (DAA first) when the second phase is swing; even passes run
        left-to-right and start narrow.  (reference segment.py:822-850)
        """
        second = self._single_leg_phase(second_phase_ind)
        if ordinal % 2 == 1:
            if second is Phase.BL:
                return [Phase.DAA, Phase.BL, Phase.DAE, Phase.AS]
            return [Phase.DAE, Phase.AS, Phase.DAA, Phase.BL]
        if second is Phase.BL:
            return [Phase.DAE, Phase.BL, Phase.DAA, Phase.AS]
        return [Phase.DAA, Phase.AS, Phase.DAE, Phase.BL]

    def _cycle_dict(
        self, order: Sequence[Phase], indices: Sequence[int]
    ) -> "OrderedDict[Phase, slice]":
        slices = [
            slice(
                self._to_framesubfr(indices[i]),
                self._to_framesubfr(indices[i + 1] - 1),
            )
            for i in range(len(indices) - 1)
        ]
        return OrderedDict(zip(order, slices))

    def _organize(self, transitions: Sequence[int]) -> Segments:
        """Per-pass phase transitions + trecho end -> nested mapping.

        Each pass consumes a fixed block of ``4 * n_cycles + 2``
        transitions: one single-support lead-in, ``4 * n_cycles`` phase
        starts, and the closing transition that ends its last phase
        (the reference hardcodes the 10-per-pass offsets of its 4x2
        protocol at segment.py:906-917).
        """
        block = 4 * self._n_cycles + 2
        segments = {}
        for t, trecho in enumerate(self._trecho_keys):
            chunk = list(transitions[t * block : (t + 1) * block])
            boundaries = chunk[1:]  # 4*n_cycles phase starts + end
            # Derive the phase order per CYCLE from that cycle's own
            # second phase: the reference's 4x2 protocol repeats one
            # support pattern within a pass (so this matches its
            # per-pass derivation, reference segment.py:822-850), but
            # generalized protocols may alternate the swing leg between
            # cycles — a single per-pass order would swap every label
            # in the alternated cycles.
            segments[trecho] = {
                cyc: self._cycle_dict(
                    self._phase_order(boundaries[4 * c + 1], t + 1),
                    boundaries[4 * c : 4 * c + 5],
                )
                for c, cyc in enumerate(self._cycle_keys)
            }
        return segments


#: A segment spec: a trecho, or a ``(trecho, cycle)`` /
#: ``(trecho, cycle, phase)`` tuple — exactly what
#: :meth:`Segmenter.get_times_of` accepts as its first argument.
TimeSpec = Union[int, "Trecho", tuple]


class SegmentPlotter:
    """Shade gait segments over signal plots.

    Reproduces the reference's full visual-inspection surface
    (reference project/segment.py:301-664): translucent
    :class:`~matplotlib.patches.Rectangle` overlays sized from the
    segment's time extent and the axes' current y-limits,
    focused x-limits with the reference's 30 % trecho margin
    (segment.py:390-407 ``_compute_focused_xlim``), the
    reactions-with-rectangle workflow (``plot_segment_og``,
    segment.py:329-388), and the device-column plots with optional
    per-axis shading (``plot_segment``, segment.py:471-583;
    ``plot_segment_grid`` extends it to one axes per device).

    Args:
        data: the loaded capture.
        segmenter: a fitted :class:`Segmenter` (built from ``data`` when
            omitted).
    """

    def __init__(
        self, data: ViconNexusData, segmenter: Optional[Segmenter] = None
    ):
        self.data = data
        self.segmenter = segmenter if segmenter is not None else Segmenter(data)

    # -- segment -> seconds on a device's clock -----------------------
    def _get_times_in_seconds(
        self, device_type, time: TimeSpec
    ) -> Tuple[float, float]:
        """Start/end of a segment in seconds on ``device_type``'s clock.

        Mirrors reference segment.py:428-441: the ``(frame, subframe)``
        slice maps through the device's index and into its time
        sequence.  The slice's ``stop`` is exclusive; at the very end
        of the capture it is clamped to the last sample (the reference
        indexes one past and would raise there).
        """
        seg = self.segmenter.get_times_of(time)
        ind = self.data.to_index(device_type, seg)
        time_seq = self.data.time_seq(device_type)
        stop = min(ind.stop, len(time_seq) - 1)
        return float(time_seq.iloc[ind.start]), float(time_seq.iloc[stop])

    def _compute_focused_xlim(
        self, device_type, time: TimeSpec
    ) -> Tuple[float, float]:
        """X-limits zoomed to the spec's trecho with a 30 % margin
        (reference segment.py:390-407)."""
        trecho = time[0] if isinstance(time, tuple) else time
        begin, end = self._get_times_in_seconds(device_type, trecho)
        margin = (end - begin) * 0.3
        return begin - margin, end + margin

    def _calculate_rectangle_dimensions(
        self, device_type, y_min: float, y_max: float, time: TimeSpec
    ) -> Mapping[str, Union[float, Tuple[float, float]]]:
        """``xy``/``width``/``height`` kwargs for the segment rectangle
        (reference segment.py:409-426)."""
        begin, end = self._get_times_in_seconds(device_type, time)
        return {
            "xy": (begin, y_min),
            "width": end - begin,
            "height": y_max - y_min,
        }

    @staticmethod
    def _add_rectangle(
        axes,
        label: Optional[str],
        rectangle_dims: Mapping[str, Union[float, Tuple[float, float]]],
        alpha: float = 0.1,
        **patch_kwargs,
    ):
        """Add one translucent rectangle patch to ``axes`` (reference
        segment.py:638-664)."""
        from matplotlib import patches

        rect = patches.Rectangle(
            **rectangle_dims, alpha=alpha, label=label, **patch_kwargs
        )
        axes.add_patch(rect)
        return rect

    def _shade_axes(
        self,
        ax,
        device_type,
        time: TimeSpec,
        rectangle_label: Optional[str],
        alpha: float,
        show_entire: bool,
    ) -> None:
        y_min, y_max = ax.get_ylim()
        dims = self._calculate_rectangle_dimensions(
            device_type, y_min, y_max, time
        )
        self._add_rectangle(ax, rectangle_label, dims, alpha=alpha)
        if not show_entire:
            ax.set_xlim(*self._compute_focused_xlim(device_type, time))

    # -- reference plotting surface ------------------------------------
    def plot_reactions(
        self,
        show: bool = False,
        title: str = "Force plates",
        xlabel: str = "time (s)",
        ylabel: str = "Force (N), z component",
        labels: Sequence[str] = ("left plate Fz", "right plate Fz"),
        figsize: Optional[Tuple[float, float]] = None,
        **plot_kwargs,
    ):
        """Plot both plates' vertical reactions against time
        (reference segment.py:585-636)."""
        import matplotlib.pyplot as plt

        left, right = reactions(self.data)
        time = self.data.time_seq("fp")
        fig, ax = plt.subplots(figsize=figsize)
        ax.plot(time, left, label=labels[0], **plot_kwargs)
        ax.plot(time, right, label=labels[1], **plot_kwargs)
        ax.set(title=title, xlabel=xlabel, ylabel=ylabel)
        ax.legend()
        if show:  # pragma: no cover - interactive path
            plt.show()
            return None
        return fig, ax

    def plot_segment_og(
        self,
        box_legend: str,
        trecho: Union[int, "Trecho"] = 1,
        cycle=None,
        phase=None,
        y_min: float = -800.0,
        y_max: float = 0.0,
        show: bool = False,
        show_entire: bool = True,
        display_legend: bool = True,
        alpha: float = 0.1,
        **rect_kwargs,
    ):
        """Rectangle over the ground reactions marking one segment.

        The reference's reactions-inspection workflow (segment.py:
        329-388): plot both plates' Fz, overlay one labelled rectangle
        with explicit ``y_min``/``y_max`` extents, optionally zoom to
        the trecho (30 % margin).  ``trecho`` defaults to the first
        pass (the reference's default of 0 is below its own 1-based
        argument convention).
        """
        import matplotlib.pyplot as plt

        time: TimeSpec = (trecho, cycle, phase)
        begin, end = self._get_times_in_seconds("fp", time)
        fig, ax = self.plot_reactions(show=False)
        self._add_rectangle(
            ax,
            box_legend,
            {
                "xy": (begin, y_min),
                "width": end - begin,
                "height": y_max - y_min,
            },
            alpha=alpha,
            **rect_kwargs,
        )
        if not show_entire:
            ax.set_xlim(*self._compute_focused_xlim("fp", trecho))
        if display_legend:
            ax.legend()
        if show:  # pragma: no cover - interactive path
            plt.show()
            return None
        return fig, ax

    def plot_segment(
        self,
        trecho=None,
        cycle=None,
        phase=None,
        device_type: str = "fp",
        col: str = "Fz",
        device_inds: Optional[Sequence[int]] = None,
        labels: Optional[Sequence[str]] = None,
        time: Optional[TimeSpec] = None,
        rectangle_label: Optional[str] = None,
        alpha: float = 0.3,
        show: bool = True,
        show_entire: bool = True,
        show_legend: bool = False,
        **plot_kwargs,
    ):
        """Plot a column of some devices, shading the requested segment.

        Two call shapes are accepted:

        * segment-first (this framework's original surface):
          ``plot_segment(1, 1, "BL", device_type="fp", col="Fz")``;
        * device-first (the reference's surface, segment.py:471-583):
          ``plot_segment("force plate", "Fz", time=(1, 1, "BL"),
          rectangle_label="phase", show_entire=False)`` — recognized
          when the first positional argument is a device-type string
          or :class:`~muscle_synergies_tpu.data.DeviceType`; ``time``
          may be a bare trecho, ``(trecho, cycle)`` or
          ``(trecho, cycle, phase)``, and ``time=None`` draws no
          rectangle.

        The shading is a translucent rectangle spanning the axes'
        current y-limits; ``show_entire=False`` zooms x to the spec's
        trecho with the reference's 30 % margin.
        """
        import matplotlib.pyplot as plt

        if trecho is not None and not isinstance(trecho, (int, Trecho, tuple)):
            # device-first (reference) calling convention
            device_type = trecho
            if cycle is not None:
                col = cycle
            spec = time
        elif time is not None:
            spec = time
        elif trecho is not None:
            spec = (trecho, cycle, phase)
        else:
            spec = None

        fig, ax = self.data.plot_cols(
            device_type,
            col,
            device_inds=device_inds,
            labels=labels,
            show=False,
            **plot_kwargs,
        )
        if spec is not None:
            self._shade_axes(
                ax, device_type, spec, rectangle_label, alpha, show_entire
            )
        if show_legend and (rectangle_label is not None or labels is not None):
            ax.legend()
        if show:  # pragma: no cover - interactive path
            plt.show()
            return None
        return fig, ax

    def plot_segment_grid(
        self,
        device_type: str,
        col: str,
        device_inds: Optional[Sequence[int]] = None,
        labels: Optional[Sequence[str]] = None,
        time: Optional[TimeSpec] = None,
        rectangle_label: Optional[str] = None,
        alpha: float = 0.1,
        show: bool = False,
        show_entire: bool = True,
        **plot_kwargs,
    ):
        """One axes per device, each shaded with its own rectangle.

        Beyond-reference companion to :meth:`plot_segment`: instead of
        overlaying every device on one axes, draw a shared-x column of
        subplots (one per selected device) and add the segment
        rectangle to each, sized from that axes' own y-limits — the
        multi-signal inspection view the reference notebook builds by
        hand around ``plot_segment``.

        Returns:
            ``(fig, axes)`` with ``axes`` a flat list, one per device.
        """
        import matplotlib.pyplot as plt

        series = self.data.get_cols(
            device_type, device_inds=device_inds, cols=col
        )
        if not isinstance(series, tuple):
            series = (series,)
        if labels is None:
            try:
                devices = self.data[device_type]
                if device_inds is not None:
                    devices = [devices[i] for i in device_inds]
                names = [d.name for d in devices]
            except (KeyError, TypeError):  # EMG: one device, one series
                names = []
            labels = names if len(names) == len(series) else [None] * len(series)
        t = self.data.time_seq(device_type)
        fig, axes = plt.subplots(
            len(series), 1, sharex=True, squeeze=False
        )
        axes = [a for row in axes for a in row]
        for ax, s, label in zip(axes, series, labels):
            ax.plot(t, s, **plot_kwargs)
            if label:
                ax.set_ylabel(label)
            if time is not None:
                self._shade_axes(
                    ax, device_type, time, rectangle_label, alpha, show_entire
                )
        if show:  # pragma: no cover - interactive path
            plt.show()
            return None
        return fig, axes
