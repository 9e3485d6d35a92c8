"""chip_smoke.py refuses to report a result without a GPU or a checkout."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=240,
    )


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu_or_checkout(where, tmp_path):
    """On a CPU-only process (the checkout) and in a directory that holds
    chip_smoke.py and nothing else, the script exits non-zero and prints
    no result line."""
    if where == "alone":
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    else:
        cwd = ROOT
    r = _run(cwd, os.path.join(cwd, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "FAIL" in r.stderr
