"""Multi-host (multi-process) domain decomposition: 2 processes x 4 virtual
CPU devices form one 8-way mesh; the sharded FDTD must stay bit-exact vs a
single-process single-device run.

This exercises cross-process collectives (Gloo on CPU; NCCL across hosts) in
the halo-exchange path — the `jax.distributed` deployment mode of
`run_fdtd(mesh=...)`. New test tier with no reference counterpart
(SURVEY.md sections 2.8/4).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_mesh_bit_parity(tmp_path):
    # single-process, single-device reference on the same case as the worker
    from babelbrain_tpu.ops.fdtd import FDTDGrid, run_fdtd, stable_dt

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
    ref = run_fdtd(idx, mats, grid, source_amp=amp, source_phase=ph)
    ref_path = tmp_path / "ref.npz"
    np.savez(ref_path, p_amp=ref["p_amp"], peak=ref["peak"])

    env = dict(os.environ)
    env.update(
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    port = str(_free_port())
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", port, str(ref_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-3000:]}"
        assert "MULTIHOST-PASS" in out
