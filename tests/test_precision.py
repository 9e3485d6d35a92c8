"""Every float32 matrix product on the device path asks for HIGHEST precision.

On a GPU a float32 product at default precision may run in TF32, which
keeps a 10-bit mantissa: voxel coordinates near 300 would move by 0.1-0.3
voxel and Rayleigh phases at k*r ~ 1e3 by ~0.5 rad. The check walks the
traced jaxpr, so it holds on any backend.
"""

import functools

import jax
import jax.extend.core as jex
import jax.numpy as jnp
import numpy as np
import pytest


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in ``jaxpr`` and its sub-jaxprs."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else (v,):
                    if isinstance(sub, jex.ClosedJaxpr):
                        walk(sub.jaxpr)
                    elif isinstance(sub, jex.Jaxpr):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _rayleigh():
    from babelbrain_tpu.ops.rayleigh import _rayleigh_blocks

    f = functools.partial(_rayleigh_blocks, point_block=8, elem_block=4)
    z = jnp.zeros
    return jax.make_jaxpr(f)(1.0, 0.1, z((6, 3)), z(6), z(6), z((10, 3)))


def _resample():
    from babelbrain_tpu.ops.imaging import _resample

    f = functools.partial(_resample, out_shape=(4, 5, 6), order=1)
    return jax.make_jaxpr(f)(jnp.zeros((5, 5, 5)), jnp.eye(3), jnp.zeros(3))


def _resample_cubic():
    from babelbrain_tpu.ops.imaging import _resample_cubic

    f = functools.partial(_resample_cubic, out_shape=(4, 5, 6))
    return jax.make_jaxpr(f)(jnp.zeros((5, 5, 5)), jnp.eye(3), jnp.zeros(3))


def _resample_rigid():
    from babelbrain_tpu.pipeline.coreg import _resample_rigid

    f = functools.partial(_resample_rigid, shape=(4, 5, 6))
    return jax.make_jaxpr(f)(jnp.zeros((5, 5, 5)), jnp.zeros(6),
                             center=jnp.ones(3))


def _mutual_information():
    from babelbrain_tpu.pipeline.coreg import _mutual_information

    x = jnp.asarray(np.random.default_rng(0).uniform(size=(4, 5, 6)),
                    jnp.float32)
    return jax.make_jaxpr(_mutual_information)(x, x)


@pytest.mark.parametrize(
    "trace",
    [_rayleigh, _resample, _resample_cubic, _resample_rigid,
     _mutual_information],
    ids=lambda f: f.__name__.lstrip("_"),
)
def test_every_dot_is_highest(trace):
    precisions = _dot_precisions(trace())
    assert precisions, "no matrix product traced"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p is not None and all(q == highest for q in p), precisions
