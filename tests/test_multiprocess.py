"""Real multi-process jax.distributed integration (VERDICT round-1 #3).

Spawns TWO OS processes that form one jax.distributed CPU mesh
(2 local devices each -> 4 global devices, gloo collectives — the local
test shape of a multi-host deployment, SURVEY.md section 5.8/7 step 7) and runs:

- the tracking block program with the channel axis sharded ACROSS
  processes (per-satellite channel parallelism over hosts),
- overlap-save halo exchange of IF time shards (ppermute across the
  process boundary — the GNU Radio ring-buffer history replaced by a
  collective, gnss_flowgraph.cc:406-523),
- cross-process non-coherent acquisition dwell accumulation (psum).

The tracking outputs must be bit-identical to a single-process run of
the same program: partitioning the channel axis must not change a single
arithmetic result.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "mh_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_mesh_matches_single_process(tmp_path):
    port = _free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["PYTHONPATH"] = REPO
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2",
             f"127.0.0.1:{port}", str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=500)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out.decode(errors="replace"))
        assert p.returncode == 0, logs[-1][-3000:]

    data = np.load(tmp_path / "mh_out.npz")
    n_dev = int(data["n_dev"])
    assert n_dev == 4

    # single-process reference of the identical program
    from __graft_entry__ import _example_inputs
    from gnss_sdr_tpu.tracking import TrackingConfig, TrackingEngine

    cfg = TrackingConfig(fs=1.0e5)
    engine = TrackingEngine(cfg, 2 * n_dev, block_samples=400)
    state, block_re, block_im, codes = _example_inputs(engine, seed=11)
    ref = []
    for _ in range(3):
        state, out = engine._block_step(state, block_re, block_im, codes)
        ref.append(np.asarray(out["prompt_re"]))
    ref = np.stack(ref)
    assert ref.shape == data["prompts"].shape
    # bit-identical: channel-axis partitioning must not perturb arithmetic
    assert np.array_equal(ref, data["prompts"]), (
        np.max(np.abs(ref - data["prompts"])))

    # halo exchange correctness across the process boundary
    shards = data["halo_in"]
    haloed = data["haloed"]
    for d in range(n_dev):
        np.testing.assert_array_equal(haloed[d, :64], shards[d])
        if d < n_dev - 1:
            np.testing.assert_array_equal(haloed[d, 64:], shards[d + 1, :16])
        else:
            np.testing.assert_array_equal(haloed[d, 64:], 0.0)

    # psum dwell fusion: every shard holds the global sum
    total = data["grids"].sum(axis=0)
    for d in range(n_dev):
        np.testing.assert_allclose(data["summed"][d], total, rtol=1e-6)

    # production fast engine sharded ACROSS the 2-process mesh:
    # bit-identical packed records (asserted in-worker against the
    # unsharded run) and identical to this process's local reference
    assert bool(data["fast_identical"]), \
        "fast-engine superblock diverged across the process mesh"
    from __graft_entry__ import _fast_engine_sharded_case
    from gnss_sdr_tpu.parallel import make_mesh

    local_ref, _ = _fast_engine_sharded_case(make_mesh(1), n_dev)
    assert np.array_equal(local_ref, data["fast_packed"])
