"""Worker process for the multi-host validation tier.

Launched by ``tests/test_multihost.py`` as N separate processes, each owning
a slice of virtual CPU devices; together they form one global JAX runtime
(`jax.distributed.initialize`) so the shard_map halo-exchange path runs its
collectives across process boundaries — the same code path a multi-host
GPU cluster uses over its network. The reference has no distributed story at all
(SURVEY.md section 2.8); this tier is new capability.

Usage: python multihost_worker.py <pid> <nprocs> <port> <ref_npz>
(env must pin JAX to CPU with forced host devices *before* start).
"""

import sys


def main():
    pid, nprocs, port, ref_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
    )
    import jax

    jax.distributed.initialize(
        f"localhost:{port}", num_processes=nprocs, process_id=pid
    )
    import numpy as np

    from babelbrain_tpu.ops.fdtd import FDTDGrid, run_fdtd, stable_dt
    from babelbrain_tpu.parallel.halo import make_mesh

    assert jax.process_count() == nprocs

    # identical case to the parent's single-process reference
    F0, C = 500e3, 1500.0
    shape = (96, 32, 56)
    dx = C / F0 / 9
    ppp = int(np.ceil(1 / F0 / stable_dt(dx, 2494.0, cfl=0.9)))
    dt = 1 / F0 / ppp
    nsteps = ppp * 4
    grid = FDTDGrid(
        shape=shape, dx=dx, dt=dt, n_steps=nsteps, frequency=F0, npml=8,
        sensor_start=nsteps - 2 * ppp, source_plane_z=9,
    )
    mats = np.array(
        [[1000.0, C, 0, 0, 0], [1896.5, 2494.0, 1594.0, 106.0, 214.0]]
    )
    idx = np.zeros(shape, np.uint8)
    idx[:, :, 28:34] = 1
    rng = np.random.default_rng(0)
    amp = np.zeros(shape[:2])
    amp[12:-12, 12:-12] = 60e3 * rng.uniform(0.5, 1, (72, 8))
    ph = rng.uniform(-3, 3, shape[:2])

    mesh = make_mesh(len(jax.devices()))
    out = run_fdtd(idx, mats, grid, source_amp=amp, source_phase=ph, mesh=mesh)

    ref = np.load(ref_path)
    np.testing.assert_array_equal(out["p_amp"], ref["p_amp"])
    np.testing.assert_array_equal(out["peak"], ref["peak"])
    print(f"[{pid}] MULTIHOST-PASS", flush=True)


if __name__ == "__main__":
    main()
