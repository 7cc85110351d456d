"""Plotting helpers mirroring the reference's visual API.

Capability parity with the reference (src/muscle_synergies/analysis.py):
- :func:`plot_signal`     <- analysis.py:33-107
- :func:`synergy_heatmap` <- analysis.py:110-139
- :func:`plot_fft`        <- analysis.py:142-162
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
from ._optional import pandas

from .analysis import fft_spectrum


def plot_signal(
    signal_df: pandas.DataFrame,
    *,
    title: str = "",
    plot_dims: Optional[Tuple[int, int]] = None,
    xlabel: str = "time (s)",
    ylabel: str = "V",
    xticks_off: bool = False,
    figsize: Tuple[int, int] = (18, 10),
    suptitle_fontsize: int = 20,
    show: bool = True,
    **plot_kwargs,
):
    """Plot each column of ``signal_df`` as its own subplot.

    ``plot_dims`` sets the subplot grid (defaults to one column);
    ``show=True`` displays the figure and returns ``None``, otherwise
    the figure is returned for further customization.
    """
    import matplotlib.pyplot as plt

    if plot_dims is None:
        plot_dims = signal_df.shape[1], 1
    if len(signal_df.columns) != int(np.prod(plot_dims)):
        raise ValueError(
            f"plot_dims {plot_dims} does not match "
            f"{len(signal_df.columns)} columns"
        )
    fig, axs = plt.subplots(
        plot_dims[0], plot_dims[1], figsize=figsize, squeeze=False
    )
    for ax, col in zip(axs.flat, signal_df.columns):
        signal_df[col].plot(ax=ax, **plot_kwargs)
        ax.set_title(col)
        if xticks_off:
            ax.set_xticks([])
        ax.set(xlabel=xlabel)
    fig.suptitle(title, fontsize=suptitle_fontsize)
    for row in range(min(2, axs.shape[0])):
        axs[row, 0].set_ylabel(ylabel)

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def synergy_heatmap(
    components: pandas.DataFrame,
    synergy_names: Optional[Sequence[str]] = None,
    show: bool = True,
):
    """Annotated heatmap of synergy components (one synergy per row)."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, ax = plt.subplots()
    num_synergies = components.shape[0]
    if synergy_names is None:
        synergy_names = [f"synergy {i}" for i in range(1, num_synergies + 1)]
    sns.heatmap(components, annot=True, fmt=".2f", ax=ax, yticklabels=synergy_names)
    ax.set_title("Heatmap of muscle synergies")

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def plot_fft(
    signal_df: pandas.DataFrame,
    sampling_frequency: int,
    xlabel: str = "frequency",
    **kwargs,
):
    """Plot the positive-frequency amplitude spectrum of each column."""
    spectrum_df = fft_spectrum(signal_df, sampling_frequency)
    return plot_signal(spectrum_df, xlabel=xlabel, **kwargs)


def plot_time_varying_synergies(
    result,
    sampling_frequency: Optional[int] = None,
    show: bool = True,
):
    """Visualize a :class:`~...models.cnmf.TimeVaryingSynergyResult`.

    Beyond-reference companion to :func:`synergy_heatmap` for the
    convolutive model: the left column shows each synergy's
    spatiotemporal pattern (lags x muscles heatmap), the right column
    its activation train over the trial.

    Args:
        result: output of ``find_time_varying_synergies``.
        sampling_frequency: when given, lag and time axes are labeled
            in seconds instead of samples.
        show: as in :func:`plot_signal` — show and return None, or
            return the figure for saving/testing.
    """
    import matplotlib.pyplot as plt
    import seaborn as sns

    k = len(result.synergies)
    fig, axes = plt.subplots(
        k, 2, figsize=(10, 2.4 * k), squeeze=False,
        gridspec_kw={"width_ratios": [1, 2]},
    )
    activations = result.activations
    time = np.asarray(activations.index, dtype=float)
    if sampling_frequency:
        time = time / sampling_frequency
    for ki in range(k):
        pattern = result.synergies[ki]
        sns.heatmap(
            pattern.T, ax=axes[ki][0], cbar=False, xticklabels=False
        )
        axes[ki][0].set_ylabel(f"synergy {ki}")
        axes[ki][0].set_xlabel(
            "lag (s)" if sampling_frequency else "lag (samples)"
        )
        axes[ki][1].plot(time, activations.iloc[:, ki].to_numpy())
        axes[ki][1].set_xlabel(
            "time (s)" if sampling_frequency else "time (samples)"
        )
        axes[ki][1].set_ylabel("activation")
    fig.suptitle(f"Time-varying synergies (VAF {result.vaf:.3f})")
    fig.tight_layout()

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def plot_synergy_clusters(
    clusters,
    channel_names: Optional[Sequence] = None,
    set_names: Optional[Sequence] = None,
    show: bool = True,
):
    """Visualize a :class:`~...models.stability.SynergyClusters`.

    Beyond-reference companion to :func:`synergy_heatmap` for the
    group-level analysis: the left side shows each cluster's unit-norm
    consensus synergy (a channel heatmap for spatial sets, one
    lags x muscles heatmap per cluster for time-varying sets), the
    right side the clusters x sets membership counts with each
    cluster's coverage — shared synergies read as fully filled rows.

    Args:
        clusters: output of ``cluster_synergies`` (or
            ``DatasetResult.cluster_subjects``).
        channel_names: muscle labels for the consensus heatmap columns.
        set_names: labels of the input sets (e.g. subject ids) for the
            membership columns.
        show: as in :func:`plot_signal` — show and return None, or
            return the figure for saving/testing.
    """
    import matplotlib.pyplot as plt
    import seaborn as sns

    consensus = np.asarray(clusters.consensus)
    membership = np.asarray(clusters.membership)
    k, n_sets = membership.shape
    if set_names is None:
        set_names = [f"set{j}" for j in range(n_sets)]
    row_labels = [
        f"c{i} ({cov * 100:.0f}%)"
        for i, cov in enumerate(clusters.coverage)
    ]

    if consensus.ndim == 2:
        fig, axes = plt.subplots(
            1, 2, figsize=(11, max(0.6 * k + 1.8, 3)),
            gridspec_kw={"width_ratios": [1.6, 1]},
        )
        sns.heatmap(
            consensus, ax=axes[0], annot=True, fmt=".2f",
            xticklabels=list(channel_names)
            if channel_names is not None
            else "auto",
            yticklabels=row_labels,
        )
        axes[0].set_title("consensus synergies")
        member_ax = axes[1]
    else:
        fig = plt.figure(figsize=(11, max(2.2 * k, 3)))
        gs = fig.add_gridspec(k, 2, width_ratios=[1.6, 1])
        for i in range(k):
            ax = fig.add_subplot(gs[i, 0])
            sns.heatmap(
                consensus[i].T, ax=ax, cbar=False, xticklabels=False,
                yticklabels=list(channel_names)
                if channel_names is not None
                else "auto",
            )
            ax.set_ylabel(row_labels[i])
            ax.set_xlabel("lag (samples)" if i == k - 1 else "")
        member_ax = fig.add_subplot(gs[:, 1])

    sns.heatmap(
        membership, ax=member_ax, annot=True, fmt="d",
        xticklabels=list(set_names), yticklabels=row_labels,
        cbar=False,
    )
    member_ax.set_title("membership (components per set)")

    n_shared = len(clusters.shared)
    fig.suptitle(
        f"Synergy clusters: {n_shared}/{k} shared across all "
        f"{n_sets} sets"
    )
    fig.tight_layout()

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig


def plot_space_by_time(
    result,
    sampling_frequency: Optional[int] = None,
    show: bool = True,
):
    """Visualize a :class:`~...models.nm3f.SpaceByTimeResult`.

    Three panels: the shared temporal modules as line plots, the
    shared spatial modules as a muscle heatmap, and the dataset-mean
    mixing coefficients (temporal x spatial).

    Args:
        result: output of ``find_space_by_time_synergies``.
        sampling_frequency: when given, the time axis is labeled in
            seconds instead of samples.
        show: as in :func:`plot_signal`.
    """
    import matplotlib.pyplot as plt
    import seaborn as sns

    fig, axes = plt.subplots(1, 3, figsize=(13, 3.2))
    temporal = result.temporal_modules
    time = np.arange(len(temporal), dtype=float)
    if sampling_frequency:
        time = time / sampling_frequency
    for name in temporal.columns:
        axes[0].plot(time, temporal[name].to_numpy(), label=name)
    axes[0].legend(fontsize="small")
    axes[0].set_xlabel("time (s)" if sampling_frequency else "time (samples)")
    axes[0].set_title("temporal modules")

    sns.heatmap(result.spatial_modules, ax=axes[1], annot=True, fmt=".2f")
    axes[1].set_ylabel("spatial module")
    axes[1].set_title("spatial modules")

    mean_a = result.coefficients.mean(axis=0)
    sns.heatmap(
        mean_a, ax=axes[2], annot=True, fmt=".2f",
        xticklabels=[f"s{j}" for j in range(mean_a.shape[1])],
        yticklabels=[f"t{i}" for i in range(mean_a.shape[0])],
    )
    axes[2].set_title("mean coefficients")

    fig.suptitle(f"Space-by-time decomposition (VAF {result.vaf:.3f})")
    fig.tight_layout()

    if show:  # pragma: no cover - interactive path
        plt.show()
        return None
    return fig
