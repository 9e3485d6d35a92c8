"""Checks that need an NVIDIA GPU: the card against its references.

They skip on the CPU. ``chip_smoke.py`` runs the same checks, at clinical
size, as phases on the card; here they run when pytest itself has a GPU.
"""

import pytest


@pytest.fixture
def smoke():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the card")
    import chip_smoke

    return chip_smoke


@pytest.mark.gpu
def test_resample_matches_scipy(smoke):
    smoke.check_resample()


@pytest.mark.gpu
def test_fdtd_goldens(smoke):
    smoke.check_goldens()
