"""Drop-in twin of the reference's ``vicon_data.load_csv`` module.

The reference wires a push parser out of three collaborators —
``create_reader`` / ``create_builder`` / ``create_loading_run``
(reference src/muscle_synergies/vicon_data/load_csv.py:44-93) — where a
``Reader`` is fed one CSV row at a time and a ``Builder`` turns the
accumulated state into a :class:`ViconNexusData`.

The accelerated framework ingests through one bulk decode instead (see
``muscle_synergies_tpu.io.vicon``), so these factories return thin
push-style adapters over the same shared row store: ``Reader.feed_row``
appends rows, ``Builder.build`` hands them to the bulk parser.  The
observable contract — feed every row, call ``build()``, get the same
data ``load_vicon_file`` produces, with 1-based line numbers in
errors — is identical, including the reference's *feed-time* error
semantics: the reference's state machine raises at the offending row
(reference reader.py:56-63, wrapped with the line number in
load_csv.py:128-134), so ``feed_row`` here validates the section
grammar incrementally and raises a :class:`ViconCSVError` naming the
offending 1-based line as soon as it is fed, while the heavy numeric
decode still happens in one bulk pass at ``build()``.
"""

from __future__ import annotations

import csv
from dataclasses import dataclass, field
from enum import Enum, auto
from typing import Iterator, List, Optional

from muscle_synergies_tpu.data import ViconNexusData
from muscle_synergies_tpu.io.vicon import (
    Row,
    _err,
    _parse_header_line,
    _prune_trailing,
    load_vicon_lines,
)

__all__ = (
    "csv_row_stream",
    "create_reader",
    "create_builder",
    "create_loading_run",
    "load_vicon_file",
    "Aggregator",
    "Reader",
    "Builder",
)


@dataclass
class Aggregator:
    """Shared store the Reader writes into and the Builder reads from.

    The reference's Aggregator is an incremental per-device columnar
    tree (reference vicon_data/aggregator.py:29-450); here the rows are
    kept verbatim and the column bookkeeping happens in the bulk
    decoder at ``build()`` time.
    """

    rows: List[Row] = field(default_factory=list)


class _LineKind(Enum):
    """Which grammar line the Reader expects next (reference
    definitions.py ``ViconCSVLines`` vocabulary)."""

    SECTION_TYPE = auto()
    SAMPLING_FREQ = auto()
    DEVICE_NAMES = auto()
    COORDINATES = auto()
    UNITS = auto()
    DATA = auto()
    DONE = auto()


_SECTION_WORDS = ("Devices", "Trajectories")


class Reader:
    """Push-style row consumer (reference reader.py:30-63 contract).

    Tracks the section grammar incrementally so malformed rows raise a
    :class:`ViconCSVError` *as they are fed*, matching the reference
    state machine's feed-time behavior (reference reader.py:250-330
    section/frequency states, :904-951 per-cell float validation of
    data rows).  Messages reuse the bulk parser's wording and 1-based
    line numbers so the push and bulk paths report identically.
    """

    def __init__(self, aggregator: Optional[Aggregator] = None):
        self._aggregator = aggregator if aggregator is not None else Aggregator()
        self._lineno = 0
        self._kind = _LineKind.SECTION_TYPE
        self._section = 0  # 0 = Devices, 1 = Trajectories
        self._num_cols = 0

    @property
    def aggregator(self) -> Aggregator:
        return self._aggregator

    def feed_row(self, row: Row) -> None:
        """Accept one CSV row (a list of cell strings).

        Raises:
            ViconCSVError: if the row breaks the section grammar —
                the error names this row's 1-based line number.
        """
        self._lineno += 1
        self._validate(list(row))
        self._aggregator.rows.append(list(row))

    def _validate(self, row: List[str]) -> None:
        pruned = _prune_trailing(row)
        if self._kind is _LineKind.SECTION_TYPE:
            if not pruned:
                return  # extra separator blank: legal between sections
            expected = _SECTION_WORDS[self._section]
            if pruned != [expected]:
                raise _err(
                    self._lineno,
                    f"expected section type line containing only "
                    f"{expected!r}, got {pruned!r}",
                )
            self._kind = _LineKind.SAMPLING_FREQ
        elif self._kind is _LineKind.SAMPLING_FREQ:
            if len(pruned) != 1:
                raise _err(
                    self._lineno,
                    "sampling frequency line should contain a single value",
                )
            try:
                int(pruned[0])
            except ValueError as exc:
                raise _err(
                    self._lineno, f"invalid sampling frequency: {exc}"
                ) from exc
            self._kind = _LineKind.DEVICE_NAMES
        elif self._kind is _LineKind.DEVICE_NAMES:
            _parse_header_line(pruned, self._lineno)
            self._kind = _LineKind.COORDINATES
        elif self._kind is _LineKind.COORDINATES:
            self._num_cols = len(pruned)
            self._kind = _LineKind.UNITS
        elif self._kind is _LineKind.UNITS:
            self._kind = _LineKind.DATA
        elif self._kind is _LineKind.DATA:
            if not pruned:  # blank row: the section separator
                self._section += 1
                self._kind = (
                    _LineKind.SECTION_TYPE
                    if self._section < len(_SECTION_WORDS)
                    else _LineKind.DONE
                )
                return
            # Per-cell float validation of the columns the decoder
            # will read (cells beyond num_cols are export padding and
            # ignored, matching the bulk contract and the reference's
            # DataState truncation).
            for j, cell in enumerate(row[: self._num_cols]):
                cell = cell.strip()
                if not cell:
                    continue  # empty cell -> NaN downstream
                try:
                    float(cell)
                except ValueError as exc:
                    raise _err(
                        self._lineno,
                        f"invalid data value {cell!r} in column {j}",
                    ) from exc
        # _LineKind.DONE: trailing rows after the last section are left
        # to the bulk parser's judgement at build() time.


class Builder:
    """Turns the accumulated rows into a :class:`ViconNexusData`."""

    def __init__(self, aggregator: Optional[Aggregator] = None):
        self._aggregator = aggregator if aggregator is not None else Aggregator()

    @property
    def aggregator(self) -> Aggregator:
        return self._aggregator

    def build(self) -> ViconNexusData:
        # Re-serialize with csv quoting so cells containing commas or
        # quotes survive the round trip into the bulk parser verbatim
        # (Reader.feed_row's contract is that cells are atomic).
        import io

        buf = io.StringIO()
        csv.writer(buf, lineterminator="\n").writerows(self._aggregator.rows)
        return load_vicon_lines(buf.getvalue().splitlines())


def create_reader(
    initial_state=None, aggregator: Optional[Aggregator] = None
) -> Reader:
    """Initialize a new Reader (reference load_csv.py:44-63 signature).

    ``initial_state`` existed to inject a custom parser state machine;
    the bulk decoder has no per-line states, so only the default
    (``None``) is accepted.
    """
    if initial_state is not None:
        raise ValueError(
            "custom reader states are a reference-internal extension "
            "point; the bulk ingest has no per-line state machine"
        )
    return Reader(aggregator=aggregator)


def create_builder(aggregator: Optional[Aggregator] = None) -> Builder:
    """Initialize a new Builder (reference load_csv.py:66-77 signature)."""
    return Builder(aggregator=aggregator)


@dataclass
class _LoadingRun:
    """The objects used to load the Vicon Nexus CSV file."""

    reader: Reader
    builder: Builder


def create_loading_run() -> _LoadingRun:
    """Create a Reader/Builder pair sharing one Aggregator."""
    aggregator = Aggregator()
    return _LoadingRun(
        reader=create_reader(aggregator=aggregator),
        builder=create_builder(aggregator=aggregator),
    )


def csv_row_stream(csv_filename) -> Iterator[Row]:
    """Yield the file's rows one at a time (reference load_csv.py:21-31)."""
    with open(csv_filename, newline="") as stream:
        yield from csv.reader(stream)


def load_vicon_file(csv_filename) -> ViconNexusData:
    """Reference-shaped entry point built on the push adapters.

    Behaviorally identical to
    :func:`muscle_synergies_tpu.load_vicon_file`; this variant exists
    so code that patched or wrapped the reference's ``load_csv``
    collaborators keeps a faithful seam.
    """
    run = create_loading_run()
    for row in csv_row_stream(csv_filename):
        run.reader.feed_row(row)
    return run.builder.build()
