"""Math/kernel layer (reference L5): the array-program equivalents of
VOLK_GNSSSDR kernels, tracking discriminators, loop filters and lock
detectors (SURVEY.md sections 2.6 and 2.9). All functions are pure and
jit/vmap-friendly; scalars and state travel as float32 arrays.
"""

from gnss_sdr_tpu.ops import discriminators, lock_detectors, loop_filters
from gnss_sdr_tpu.ops.correlator import multicorrelate

__all__ = ["discriminators", "lock_detectors", "loop_filters", "multicorrelate"]
