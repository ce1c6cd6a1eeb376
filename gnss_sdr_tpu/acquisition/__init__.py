"""Acquisition engines (reference layer L4, acquisition role).

The PCPS engine is one batched array program over the whole
(PRN x Doppler-bin) search grid — the array-program collapse of the
reference's per-channel serial Doppler loop + optional CUDA/OpenCL/FPGA
offload variants (SURVEY.md section 2.5).
"""

from gnss_sdr_tpu.acquisition.pcps import AcqConfig, AcqResult, PcpsAcquisition
from gnss_sdr_tpu.acquisition.tong import TongAcquisition

__all__ = ["AcqConfig", "AcqResult", "PcpsAcquisition", "TongAcquisition"]
