"""muscle_synergies_tpu: an accelerated muscle-synergy analysis framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of the
reference ``muscle_synergies`` package (Vicon Nexus CSV ingest, EMG
preprocessing, NMF-based synergy extraction) re-designed for the
accelerator: batched/sharded array pipelines, fused NMF solvers (Triton
kernels on the GPU), and mesh-parallel execution.
"""

from . import analysis, dataset, models, ops, parallel, segment, utils
from .analysis import (
    digital_filter,
    fft_spectrum,
    linear_envelope,
    normalize,
    rms,
    subsample,
    time_normalize,
    vaf,
    zero_center,
)
from .data import (
    DeviceData,
    DeviceType,
    ForcePlateMeasurement,
    SectionType,
    ViconNexusData,
)
from .frames import ForcesEMGFrameTracker, FrameSubfr, SamplingFreq, TrajFrameTracker
from .dataset import (
    DatasetResult,
    SpaceByTimeDatasetResult,
    TimeVaryingDatasetResult,
    analyze_dataset,
    analyze_dataset_pipelined,
    analyze_dataset_space_by_time,
    analyze_dataset_time_varying,
)
from .io import ViconCSVError, load_vicon_file
from .models import (
    NMFModel,
    SpaceByTimeResult,
    SynergyRunResult,
    TimeVaryingSynergyResult,
    find_space_by_time_synergies,
    find_synergies,
    find_time_varying_synergies,
    load_model,
    load_synergy_run,
    save_model,
    save_synergy_run,
)
from .viz import plot_fft, plot_signal, synergy_heatmap

__version__ = "0.1.0"

__all__ = [
    # data model + ingest
    "DeviceData",
    "DeviceType",
    "SectionType",
    "ForcePlateMeasurement",
    "ViconNexusData",
    "SamplingFreq",
    "FrameSubfr",
    "ForcesEMGFrameTracker",
    "TrajFrameTracker",
    "load_vicon_file",
    "ViconCSVError",
    # analysis
    "zero_center",
    "digital_filter",
    "linear_envelope",
    "rms",
    "normalize",
    "subsample",
    "time_normalize",
    "fft_spectrum",
    "vaf",
    # synergies
    "NMFModel",
    "SynergyRunResult",
    "find_synergies",
    "save_model",
    "load_model",
    "save_synergy_run",
    "load_synergy_run",
    "find_time_varying_synergies",
    "find_space_by_time_synergies",
    "SpaceByTimeResult",
    "TimeVaryingSynergyResult",
    "analyze_dataset",
    "analyze_dataset_pipelined",
    "analyze_dataset_space_by_time",
    "analyze_dataset_time_varying",
    "DatasetResult",
    "SpaceByTimeDatasetResult",
    "TimeVaryingDatasetResult",
    # viz
    "plot_signal",
    "plot_fft",
    "synergy_heatmap",
    # submodules
    "analysis",
    "dataset",
    "models",
    "ops",
    "parallel",
    "segment",
    "utils",
]
