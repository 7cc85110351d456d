#!/usr/bin/env python
"""Preprocessing benchmark: zero-phase filtering throughput.

Times the associative-scan `sosfiltfilt` on the full-trial EMG shape
(124,460 samples x 8 channels, order-13 Butterworth low-pass — the
tutorial's envelope filter) on the default JAX device, against
scipy.signal.sosfiltfilt on the host CPU.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--samples", type=int, default=124_460)
    parser.add_argument("--channels", type=int, default=8)
    parser.add_argument("--order", type=int, default=13)
    parser.add_argument("--repeats", type=int, default=3)
    parser.add_argument("--platform", default=None)
    args = parser.parse_args()

    if args.platform:
        import jax

        jax.config.update("jax_platforms", args.platform)

    import jax
    import jax.numpy as jnp
    from scipy import signal as sps

    from muscle_synergies_tpu.ops import sos_design, sosfiltfilt

    rng = np.random.default_rng(0)
    x = np.abs(rng.standard_normal((args.samples, args.channels))).astype(
        np.float32
    )
    sos = sos_design(args.order, 4.0, 2000.0)

    # ours (device): difference two chain lengths of dependent calls —
    # fixed dispatch latency cancels
    y = sosfiltfilt(sos, jnp.asarray(x))
    float(jnp.sum(y))  # compile + sync

    def chain(k, seed):
        z = jnp.asarray(x + seed * 1e-6)
        t0 = time.perf_counter()
        for _ in range(k):
            z = sosfiltfilt(sos, jnp.abs(z) + 0.01)
        float(jnp.sum(z))
        return time.perf_counter() - t0

    samples = []
    for rep in range(args.repeats):
        t1 = chain(2, 10 * rep + 1)
        t2 = chain(52, 10 * rep + 2)
        samples.append((t2 - t1) / 50)
    ours = max(float(np.median(samples)), 1e-5)

    # scipy (host), same dtype as the device path, best of repeats
    scipy_samples = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        sps.sosfiltfilt(sos, x, axis=0)
        scipy_samples.append(time.perf_counter() - t0)
    scipy_time = float(np.median(scipy_samples))

    print(
        f"ours {ours * 1e3:.1f} ms vs scipy {scipy_time * 1e3:.1f} ms "
        f"({args.samples}x{args.channels}, order {args.order})",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "zero_phase_filter_speedup_vs_scipy",
        "value": round(scipy_time / ours, 2),
        "unit": (
            f"x ({args.samples}x{args.channels}, order {args.order})"
        ),
        "vs_baseline": round(scipy_time / ours, 2),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
