"""Every device contraction states full float32 precision.

A GPU may run a float32 product at default precision in TF32 (~3 decimal
digits). These tests walk the traced programs (jaxprs, sub-jaxprs
included) and require ``Precision.HIGHEST`` on every ``dot_general`` and
convolution.
"""

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest

from gnss_sdr_tpu.codes import gps_l1ca_code
from gnss_sdr_tpu.tracking import TrackingConfig
from gnss_sdr_tpu.tracking.fast_engine import FastTrackingEngine

CONTRACTIONS = ("dot_general", "conv_general_dilated")


def _walk(jaxpr):
    for eqn in jaxpr.eqns:
        yield eqn
        for val in eqn.params.values():
            for sub in val if isinstance(val, (tuple, list)) else (val,):
                if isinstance(sub, jex.ClosedJaxpr):
                    yield from _walk(sub.jaxpr)
                elif isinstance(sub, jex.Jaxpr):
                    yield from _walk(sub)


def _eqns(fn, *args, **kw):
    return list(_walk(jax.make_jaxpr(fn, **kw)(*args).jaxpr))


def _is_highest(eqn) -> bool:
    prec = eqn.params.get("precision")
    if prec is None:
        return False
    pair = prec if isinstance(prec, tuple) else (prec, prec)
    return all(p == jax.lax.Precision.HIGHEST for p in pair)


def _assert_all_highest(eqns, expect_some=True):
    found = [e for e in eqns if e.primitive.name in CONTRACTIONS]
    if expect_some:
        assert found, "no contraction traced"
    loose = [str(e) for e in found if not _is_highest(e)]
    assert not loose, loose


@pytest.mark.parametrize("correlator,loop,pilot", [
    ("bank", "fllpll", False), ("bank", "kf", False),
    ("bank", "gaussian", False), ("segsum", "fllpll", False),
    ("bank", "fllpll", True), ("segsum", "fllpll", True)])
def test_fast_engine_superblock_contractions(correlator, loop, pilot):
    cfg = TrackingConfig(fs=1.0e5, extend_correlation_symbols=4,
                         track_pilot=pilot)
    engine = FastTrackingEngine(cfg, 2, groups_per_block=2,
                                correlator=correlator, loop=loop)
    codes = jnp.asarray(np.stack([np.asarray(gps_l1ca_code(p), np.float32)
                                  for p in (1, 2)]))
    tables = [engine._get_bank(codes) if correlator == "bank" else codes]
    if pilot:
        tables.append(engine._get_data_bank(codes)
                      if correlator == "bank" else codes)
    ring = jnp.zeros((2, 2 * engine.block_samples + engine.overlap),
                     jnp.int8)
    _assert_all_highest(_eqns(engine._superblock_ring_i8, engine.init_state(),
                              ring, jnp.int32(0), 2, *tables,
                              static_argnums=(3,)))


def test_acquisition_grid_uses_fft_not_products():
    from gnss_sdr_tpu.acquisition.pcps import _pcps_magnitude_grid

    n, p, d = 64, 2, 3
    eqns = _eqns(lambda *a: _pcps_magnitude_grid(*a, offset=0, eff=n),
                 jnp.zeros(n), jnp.zeros(n), jnp.zeros((p, n)),
                 jnp.zeros((p, n)), jnp.zeros(d), jnp.float32(4e6))
    assert any(e.primitive.name == "fft" for e in eqns)
    _assert_all_highest(eqns, expect_some=False)


def _fir():
    from gnss_sdr_tpu.conditioner.fir import fir_filter

    x = (jnp.ones(32), jnp.ones(32))
    return lambda: fir_filter(x, np.ones(5, np.float32), 2)


def _beamform():
    from gnss_sdr_tpu.conditioner.beamformer import beamform

    x, w = jnp.ones((4, 16)), jnp.ones(4)
    return lambda: beamform(x, x, w, w)


def _cubature():
    from gnss_sdr_tpu.ops.nonlinear import cubature_predict, cubature_update

    x, p = jnp.zeros(2), jnp.eye(2)

    def run():
        xp, pp = cubature_predict(lambda v: v * 2.0, x, p, p)
        return cubature_update(lambda v: v[:1], xp, pp, jnp.ones(1),
                               jnp.eye(1))
    return run


def _unscented():
    from gnss_sdr_tpu.ops.nonlinear import (unscented_predict,
                                            unscented_update)

    x, p = jnp.zeros(2), jnp.eye(2)

    def run():
        xp, pp = unscented_predict(lambda v: v * 2.0, x, p, p)
        return unscented_update(lambda v: v[:1], xp, pp, jnp.ones(1),
                                jnp.eye(1))
    return run


@pytest.mark.parametrize("build", [_fir, _beamform, _cubature, _unscented],
                         ids=["fir", "beamform", "cubature", "unscented"])
def test_conditioner_and_filter_contractions(build):
    _assert_all_highest(_eqns(build()))
