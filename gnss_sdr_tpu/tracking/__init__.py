"""Tracking engines (reference layer L4, tracking role).

The DLL/PLL/FLL engine processes fixed-size blocks of IF samples for all
channels at once: a ``lax.scan`` over PRN periods with every per-period
quantity batched over the channel axis — the array-program collapse of the
reference's one-thread-per-channel ``dll_pll_veml_tracking`` blocks and
their CPU/CUDA/FPGA multicorrelator variants (SURVEY.md section 2.6).
"""

from gnss_sdr_tpu.tracking.engine import (
    TrackingConfig,
    TrackingEngine,
    TrackState,
)

__all__ = ["TrackingConfig", "TrackingEngine", "TrackState"]
