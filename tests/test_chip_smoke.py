"""chip_smoke.py's checks at tiny shapes on the CPU; the script itself
refuses to run without a GPU."""

import numpy as np
import pytest

import chip_smoke as cs


def test_main_without_gpu_fails_and_prints_no_result(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and out.strip() == ""


def _tiny_acq(bit_transition=False):
    from gnss_sdr_tpu.acquisition.adapters import make_acquisition

    return make_acquisition("GPS_L1_CA_PCPS_Acquisition", [3, 7], 1.0e6,
                            doppler_max=1000.0, doppler_step=500.0,
                            bit_transition_flag=bit_transition)


@pytest.mark.parametrize("bit_transition", [False, True])
def test_acq_case_passes_on_device_grid(bit_transition, capsys):
    stats = cs.acq_case("tiny", _tiny_acq(bit_transition), seed=4, reps=1)
    assert cs.grid_ok(stats) and not stats["truth_missed"]
    assert stats["shape"] == [2, 4, 1000]
    assert "ms/grid" in capsys.readouterr().out


def test_compare_grids_flags_error_and_moved_peak():
    rng = np.random.default_rng(0)
    ref = rng.random((2, 3, 50))
    ref[0, 1, 7] = ref[1, 2, 9] = 10.0
    assert cs.grid_ok(cs.compare_grids(ref.astype(np.float32), ref))
    off = ref.copy()
    off[0, 0, 0] += 1e-2
    assert not cs.grid_ok(cs.compare_grids(off, ref))
    moved = ref.copy()
    moved[1, 0, 0] = 11.0
    stats = cs.compare_grids(moved, ref)
    assert stats["argmax_moved"] == [1] and not cs.grid_ok(stats)
    bad = ref.copy()
    bad[0, 0, 0] = np.nan
    assert not cs.grid_ok(cs.compare_grids(bad, ref))


K = 2


def _packed(seed=0, groups=3, channels=2):
    """Synthetic [B=1, G, C, 5K+4] record (fast_engine ``packed``)."""
    rng = np.random.default_rng(seed)
    p = np.zeros((1, groups, channels, 5 * K + 4))
    p[..., :K] = np.arange(K) * 100 + 10                 # starts
    p[..., K:2 * K] = 0.5                                # rems
    p[..., 3 * K:4 * K] = 1.0 + 0.1 * rng.random(K)      # data_re
    p[..., 4 * K:5 * K] = 0.1 * rng.random(K)            # data_im
    p[..., 5 * K] = 1234.0                               # Doppler
    p[..., 5 * K + 2] = 1.0                              # valid
    return p


def test_compare_tracks_identical():
    stats = cs.compare_tracks(_packed(), _packed(), K)
    assert cs.tracks_ok(stats)
    assert stats["groups"] == 6 and stats["starts_unequal"] == 0


def test_compare_tracks_start_rollover_within_code_phase():
    """start 10 + rem 0.999 vs start 11 + rem 0.0 is the same boundary."""
    a, b = _packed(), _packed()
    a[0, 0, 0, 0], a[0, 0, 0, K] = 10.0, 0.999
    b[0, 0, 0, 0], b[0, 0, 0, K] = 11.0, 0.0
    stats = cs.compare_tracks(a, b, K)
    assert stats["starts_unequal"] == 1 and cs.tracks_ok(stats)


@pytest.mark.parametrize("field,delta", [
    ("doppler", 2.0), ("prompt", 0.05), ("phase", 0.05), ("valid", -1.0)])
def test_compare_tracks_rejects(field, delta):
    a, b = _packed(), _packed()
    if field == "doppler":
        b[0, 1, 1, 5 * K] += delta
    elif field == "prompt":
        b[0, 1, 1, 3 * K:4 * K] *= 1.0 + delta
        b[0, 1, 1, 4 * K:5 * K] *= 1.0 + delta
    elif field == "phase":
        b[0, 2, 0, K] += delta
    else:
        b[0, 0, 1, 5 * K + 2] = 0.0
    assert not cs.tracks_ok(cs.compare_tracks(a, b, K))


def test_truth_errors_reads_last_group():
    from gnss_sdr_tpu.simulate import SatelliteParams

    sats = [SatelliteParams(prn=1, doppler_hz=1230.0),
            SatelliteParams(prn=2, doppler_hz=1236.0)]
    t = cs.truth_errors(_packed(), K, sats)
    assert t == {"max_doppler_err_hz": 4.0, "lost": 0}


def test_e2e_bounds():
    good = {"rc": 0, "in_fast_mode": True, "fixes": 5, "mean_err_m": 2.0}
    assert cs.e2e_ok(good)
    for key, bad in (("rc", 1), ("in_fast_mode", False), ("fixes", 4),
                     ("mean_err_m", 5.0), ("mean_err_m", float("nan"))):
        assert not cs.e2e_ok({**good, key: bad})
