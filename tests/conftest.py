"""Test fixtures. The 8-device CPU mesh flag is set in the root conftest.py."""

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
