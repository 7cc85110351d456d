"""Drop-in twin of the reference's ``vicon_data.definitions`` module.

Reference-era scripts import the L0 type vocabulary from here
(reference src/muscle_synergies/vicon_data/definitions.py:18-199):
``Row``, ``SectionType``, ``ViconCSVLines``, ``DeviceType``,
``ForcePlateMeasurement``, ``SamplingFreq``.  All names resolve to the
accelerated framework's implementations, which keep the same enum members,
``DeviceType.from_str`` strings, ``DeviceType.section_type`` mapping
and the ``SamplingFreq.num_subframes`` integer-ratio rule.
"""

from muscle_synergies_tpu.data import (
    DeviceType,
    ForcePlateMeasurement,
    SectionType,
)
from muscle_synergies_tpu.frames import SamplingFreq
from muscle_synergies_tpu.io.vicon import Row, ViconCSVLines

__all__ = (
    "Row",
    "SectionType",
    "ViconCSVLines",
    "DeviceType",
    "ForcePlateMeasurement",
    "SamplingFreq",
)
