"""The associative-scan ``sosfiltfilt``/``sosfilt`` against scipy.

Long, ill-conditioned cascades (the order-13, 4 Hz / 2 kHz tutorial
envelope), wide channel counts, explicit initial states and the
vmapped multi-trial form; float64 here (the envelope path also runs
its filter in float64 on the device, see ``dataset.preprocess_trials``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy import signal as sps

from muscle_synergies_tpu.dataset import preprocess_trials
from muscle_synergies_tpu.ops.filters import sosfilt, sosfiltfilt
from muscle_synergies_tpu.utils.config import PipelineConfig

RNG = np.random.default_rng(11)


def _sig(n, c):
    return RNG.standard_normal((n, c))


DESIGNS = [
    dict(n=5000, c=3, order=4, fs=100.0, fc=10.0),
    dict(n=4096, c=8, order=13, fs=2000.0, fc=4.0),  # tutorial envelope
    dict(n=3000, c=1, order=2, fs=100.0, fc=5.0),
    dict(n=2500, c=9, order=3, fs=1000.0, fc=40.0),  # force-plate width
    dict(n=2048, c=16, order=5, fs=500.0, fc=60.0),
]


@pytest.mark.parametrize("design", DESIGNS)
def test_filtfilt_matches_scipy(design):
    x = _sig(design["n"], design["c"])
    sos = sps.butter(
        design["order"], design["fc"], output="sos", fs=design["fs"]
    )
    mine = np.asarray(sosfiltfilt(sos, x))
    ref = sps.sosfiltfilt(sos, x, axis=0)
    # the scan composes the section maps in another order than scipy's
    # recursion: on the order-13 near-unit-pole cascade that leaves
    # ~7e-9 of the signal scale in float64, ~1e-11 on the others
    scale = np.max(np.abs(ref))
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-8 * scale)


def test_cascade_matches_scipy_sosfilt():
    x = _sig(3000, 4)
    sos = sps.butter(6, 20.0, output="sos", fs=500.0)
    zi = sps.sosfilt_zi(sos)[:, :, None] * x[0]
    ref, _ = sps.sosfilt(sos, x, axis=0, zi=zi)
    mine = np.asarray(sosfilt(sos, x, zi))
    np.testing.assert_allclose(mine, ref, rtol=1e-10, atol=1e-12)


def test_cascade_zero_zi():
    x = _sig(2000, 2)
    sos = sps.butter(4, 10.0, output="sos", fs=100.0)
    ref = sps.sosfilt(sos, x, axis=0)
    zi = np.zeros((sos.shape[0], 2, 2))
    mine = np.asarray(sosfilt(sos, x, zi))
    np.testing.assert_allclose(mine, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("padtype", ["even", "constant", None])
def test_padtype_variants(padtype):
    x = _sig(2000, 2)
    sos = sps.butter(4, 10.0, output="sos", fs=100.0)
    mine = np.asarray(sosfiltfilt(sos, x, padtype=padtype))
    ref = sps.sosfiltfilt(sos, x, axis=0, padtype=padtype)
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-10)


def test_explicit_padlen_and_1d():
    x = _sig(1500, 1)[:, 0]
    sos = sps.butter(4, 10.0, output="sos", fs=100.0)
    mine = np.asarray(sosfiltfilt(sos, x, padlen=64))
    ref = sps.sosfiltfilt(sos, x, padlen=64)
    assert mine.ndim == 1
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-10)


def test_vmapped_over_trials():
    # the batched envelope path vmaps the filter over a trial axis
    xs = np.stack([_sig(2000, 4) for _ in range(3)])
    sos = sps.butter(4, 10.0, output="sos", fs=100.0)
    batched = np.asarray(
        jax.vmap(lambda x: sosfiltfilt(sos, x))(jnp.asarray(xs))
    )
    for b in range(3):
        ref = sps.sosfiltfilt(sos, xs[b], axis=0)
        np.testing.assert_allclose(batched[b], ref, rtol=1e-9, atol=1e-10)


def test_short_signal_rejected():
    sos = sps.butter(4, 10.0, output="sos", fs=100.0)
    with pytest.raises(ValueError, match="padlen"):
        sosfiltfilt(sos, np.ones((5, 2)))


def test_bad_padtype_rejected():
    sos = sps.butter(4, 10.0, output="sos", fs=100.0)
    with pytest.raises(ValueError, match="padtype"):
        sosfiltfilt(sos, np.ones((500, 2)), padtype="reflect")


def test_wide_channel_count():
    """High-density grids: hundreds of channels in one call."""
    x = _sig(1000, 256)
    sos = sps.butter(2, 10.0, output="sos", fs=100.0)
    mine = np.asarray(sosfiltfilt(sos, x))
    ref = sps.sosfiltfilt(sos, x, axis=0)
    np.testing.assert_allclose(mine, ref, rtol=1e-9, atol=1e-10)


def test_envelope_filter_runs_in_float64_under_float32():
    """With 64-bit types off, the dataset envelope still filters in
    float64 and only returns float32: the float32 scan of the 4 Hz /
    2 kHz lowpass is off by percents over a long capture."""
    x = np.abs(_sig(20_000, 2))
    cfg = PipelineConfig()
    ref = np.asarray(preprocess_trials([x], 2000.0, cfg))[0]
    with jax.enable_x64(False):
        got = np.asarray(preprocess_trials([x], 2000.0, cfg))[0]
        sos = cfg.envelope.design(2000.0)
        raw32 = np.asarray(
            sosfiltfilt(sos, jnp.asarray(x - x.mean(0), jnp.float32))
        )
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6)
    full = sps.sosfiltfilt(sos, np.abs(x - x.mean(0)), axis=0)
    assert np.max(np.abs(np.abs(raw32) - full)) > 1e-4 * np.max(full)
