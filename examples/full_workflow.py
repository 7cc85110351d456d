#!/usr/bin/env python
"""Complete workflow example: capture -> synergies -> segmentation.

Runs on synthetic data so it works without any dataset present:

    python examples/full_workflow.py [--platform cpu]
"""

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default=None)
    args = parser.parse_args()
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import muscle_synergies_tpu as mst
    from muscle_synergies_tpu.utils.platform import enable_compile_cache

    enable_compile_cache()
    from benchmarks.end_to_end import synthesize_csv

    # --- 1. ingest -------------------------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "trial.csv")
        synthesize_csv(csv, n_frames_slow=800)
        data = mst.load_vicon_file(csv)
    print(data.describe())

    emg = data.emg.df
    fs = data.emg.sampling_frequency
    print(f"\nEMG @ {fs} Hz; frame (2, 1) ->\n{data.emg[2, 1].round(5)}")

    # --- 2. preprocess ----------------------------------------------------
    proc = mst.rms(emg, window_size=0.5, sampling_frequency=fs)
    proc = mst.time_normalize(proc, reduce_to=200)
    proc = mst.normalize(proc)

    # --- 3. synergies with a VAF rank sweep -------------------------------
    result = mst.find_synergies(proc.abs(), 2, 4, max_iter=20_000, tol=1e-6)
    print("\nVAF per rank:")
    print(result.vaf_values.round(4).to_string())
    print(f"\nrank-3 components:\n{result.components[3].round(3).to_string()}")

    # --- 4. stability + cross-validated rank ------------------------------
    from muscle_synergies_tpu.models import bootstrap_synergies, cv_rank_selection

    boot = bootstrap_synergies(proc.abs().to_numpy(), 3, n_boot=20,
                               max_iter=500)
    print("\nbootstrap stability (rank 3):", boot.mean.round(3))
    cv = cv_rank_selection(proc.abs().to_numpy(), ranks=(1, 2, 3, 4),
                           n_repeats=3, max_iter=400)
    print("cross-validated best rank:", cv.best_rank)

    # --- 4b. time-varying (convolutive) synergies --------------------------
    tv = mst.find_time_varying_synergies(
        proc.abs(), n_synergies=2, n_lags=20, n_inits=2, max_iter=300
    )
    print(f"\ntime-varying synergies (2 x 20 lags): VAF {tv.vaf:.4f}, "
          f"{tv.n_iter} iterations")
    from muscle_synergies_tpu.models import bootstrap_time_varying_synergies

    tv_boot = bootstrap_time_varying_synergies(
        proc.abs().to_numpy(), 2, n_lags=20, n_boot=8, max_iter=250
    )
    print("time-varying stability:", tv_boot.mean.round(3))

    # --- 4c. space-by-time (NM3F) decomposition ----------------------------
    import numpy as np

    from muscle_synergies_tpu import analyze_dataset_space_by_time
    from muscle_synergies_tpu.utils import PipelineConfig

    windows = [emg.iloc[i * 4000 : (i + 1) * 4000] for i in range(4)]
    cfg = PipelineConfig(use_rms=True, rms_window_s=0.25, reduce_to=150)
    sbt = analyze_dataset_space_by_time(
        windows, fs, n_temporal=3, n_spatial=2, config=cfg,
        n_inits=2, max_iter=250,
    )
    print(f"\nspace-by-time (3 temporal x 2 spatial modules): "
          f"VAF {sbt.vaf_overall:.4f}")
    print("per-trial VAF:", np.round(sbt.vaf_per_trial, 3))
    print("per-muscle VAF (trial 0):",
          np.round(sbt.vaf_per_channel[0], 3))

    # --- 5. gait segmentation + joint analysis ----------------------------
    from muscle_synergies_tpu.segment import Segmenter, phase_summary

    try:
        seg = Segmenter(data)
        table = phase_summary(data, seg)
        print("\nper-phase summary (head):")
        print(table.head(4).round(3).to_string())
    except ValueError as exc:
        print(f"\n(segmentation skipped on this synthetic trial: {exc})")

    print("\nworkflow complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
