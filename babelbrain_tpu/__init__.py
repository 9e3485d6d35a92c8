"""babelbrain_tpu: a JAX transcranial focused ultrasound (TUS) planning framework.

A ground-up JAX/XLA re-design of the capabilities of BabelBrain
(https://github.com/ProteusMRIgHIFU/BabelBrain): domain generation from
segmentation + CT/pseudo-CT, Rayleigh-Sommerfeld acoustic propagation,
staggered-grid viscoelastic FDTD through skull with CPML, phased-array
steering/refocusing, Pennes bio-heat (BHTE) thermal simulation with CEM43
dose and safety indices.

Design principles (not a port):
  * All hot compute is jittable JAX left to XLA: fused stencils under
    `lax.scan` for the FDTD and BHTE time loops, blocked matmul
    formulations at HIGHEST precision for Rayleigh.
  * Multi-device scaling via `jax.sharding.Mesh` + `shard_map`, with
    `ppermute` halo exchange for spatial domain decomposition (the
    reference is single-GPU only; see SURVEY.md section 2.8).
  * The reference's file contracts (BabelViscoInput.nii.gz, DataForSim.h5,
    thermal h5 keys) are honored so existing downstream tooling works.
"""

__version__ = "0.1.0"

from . import materials  # noqa: F401
