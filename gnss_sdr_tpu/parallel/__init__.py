"""Multi-device scale-out (SURVEY.md section 2.10 parallelism mapping).

The channel axis (satellite PRN x signal) is the natural data-parallel
axis: tracking state and per-channel code tables shard across a
``jax.sharding.Mesh`` while sample blocks are replicated (each chip reads
the same IF stream slice and tracks its own subset of satellites); the
acquisition (PRN x Doppler) grid shards over PRNs the same way. This
replaces the reference's thread-per-channel parallelism
(gnss_flowgraph.cc:1390 assign_channels) with SPMD sharding.
"""

from gnss_sdr_tpu.parallel.sharding import (
    channel_sharding,
    make_mesh,
    replicated,
    shard_tracking_state,
)

__all__ = [
    "channel_sharding",
    "make_mesh",
    "replicated",
    "shard_tracking_state",
]
