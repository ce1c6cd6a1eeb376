"""Multi-chip/multi-host collective patterns (SURVEY.md section 2.10/5.8).

The reference has no distribution; its concurrency maps onto a device mesh
as (SURVEY section 7): channels sharded across chips, IF time-blocks
sharded across hosts with overlap-save halo exchange, acquisition grids
reduced across devices. This module provides those patterns as
``shard_map`` programs — runnable on any mesh (the test suite exercises
them on 8 virtual CPU devices; across GPUs XLA hands them to NCCL).

- :func:`distributed_init` wraps jax.distributed for multi-process runs.
- :func:`halo_exchange_blocks`: each device holds one time shard of the IF
  stream and receives its right neighbor's head samples (ppermute) so
  PRN periods straddling shard edges can be tracked (the GNU Radio
  ring-buffer history, replaced by a collective).
- :func:`allreduce_noncoherent_grid`: non-coherent accumulation of
  per-device acquisition dwell grids (psum) — cross-host dwell fusion.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P


def distributed_init(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize jax.distributed for a multi-host run (no-op args ->
    environment-driven initialization)."""
    kwargs = {}
    if coordinator is not None:
        kwargs = dict(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)


def init_cpu_multiprocess(coordinator: str, num_processes: int,
                          process_id: int,
                          devices_per_process: int = 2) -> None:
    """Multi-process CPU bring-up — the local test shape of a multi-host
    ``jax.distributed.initialize()``.

    Order matters: platform/device-count/collectives go through
    jax.config BEFORE the backend initializes (the env-var route does not
    reach the CPU client's device count), and cross-process CPU
    collectives need the gloo implementation. After this returns,
    ``jax.devices()`` spans all processes and psum/ppermute ride the
    distributed runtime as they would across accelerator hosts.
    """
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", devices_per_process)
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)


def halo_exchange_blocks(mesh: Mesh, shards: jax.Array, halo: int,
                         axis: str = "ch") -> jax.Array:
    """Append each shard's successor's first ``halo`` samples.

    ``shards``: [n_dev, shard_len] (device-sharded on axis 0). Returns
    [n_dev, shard_len + halo]; the last shard's halo is zero-padded
    (stream end).
    """

    def body(x):
        # x: [1, shard_len] local shard
        n = jax.lax.axis_size(axis)
        head = x[:, :halo]
        # no wrap-around pair: ppermute zero-fills unaddressed targets, so
        # the last shard's halo is zero without a wasted send + mask
        left = jax.lax.ppermute(
            head, axis, perm=[(i, i - 1) for i in range(1, n)])
        return jnp.concatenate([x, left], axis=1)

    fn = shard_map(body, mesh=mesh, in_specs=P(axis, None),
                   out_specs=P(axis, None))
    return fn(shards)


def allreduce_noncoherent_grid(mesh: Mesh, grids: jax.Array,
                               axis: str = "ch") -> jax.Array:
    """Sum per-device acquisition magnitude grids (non-coherent dwell
    accumulation across hosts): [n_dev, D, N] sharded -> same shape with
    every shard holding the total."""

    def body(g):
        return jax.lax.psum(g, axis)

    fn = shard_map(body, mesh=mesh, in_specs=P(axis, None, None),
                   out_specs=P(axis, None, None))
    return fn(grids)
