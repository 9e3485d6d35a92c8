"""Procedural digital head: a seeded CT/MR phantom for end-to-end runs.

The reference's regression tests drive real head datasets through the full
pipeline (SURVEY.md section 4). Without them, this phantom stands in: an
ellipsoidal cranium whose skull follows published adult statistics

  * outer-table/diploe/inner-table sandwich with angular thickness
    variation (mean ~6.3 mm, sd ~1.5 mm; cortical tables ~1.5-2 mm --
    Lillie 2016 J Biomech, Alexander 2019; the anatomy the Webb HU tables
    in ``materials/data/webb_tables.npz`` were fitted on),
  * CT values per compartment from the HU ranges those tables span
    (cortical ~1200-1900 HU, diploe ~300-800 HU, soft tissue ~30-60 HU,
    air sinus -1000 HU; cap 2100 HU as `BabelDatasetPreps.py:836`),
  * a ZTE-like MR volume with the soft-bright/bone-dark contrast the
    pseudo-CT mapping expects (`CTZTEProcessing.py:591-628`),
  * a PETRA-like volume whose integer histogram carries the two peaks
    (water bath + soft tissue) the petra2Density normalization keys on
    (`CTZTEProcessing.py:556-577`),
  * a Density volume via the same mass-density law CT mode uses.

Labels follow the charm convention the pipeline consumes: 5 skin, 7 bone,
4 CSF rim, 2 GM, 1 WM, 0 air/water.
"""

from __future__ import annotations

import numpy as np


def build_head(n: int = 96, voxel_mm: float = 2.0,
               skull_radius_mm: float = 60.0, seed: int = 11):
    """Return ``(labels, ct_hu, zte, petra, density, affine)``.

    ``n`` voxels of ``voxel_mm`` per side, centred on the RAS origin;
    ``skull_radius_mm`` is the mean outer-skull radius (~60 mm is a compact
    test head, ~85 mm an adult cranium). The field of view must hold the
    skull plus its 5 mm scalp: ``n * voxel_mm / 2 > 1.05 * radius + 5``.
    """
    rng = np.random.default_rng(seed)
    half = n * voxel_mm / 2.0
    aff = np.diag([voxel_mm, voxel_mm, voxel_mm, 1.0])
    aff[:3, 3] = -half
    ax = np.arange(n) * voxel_mm - half
    x, y, z = ax[:, None, None], ax[None, :, None], ax[None, None, :]
    r = np.sqrt((x / 0.97) ** 2 + (y / 0.92) ** 2 + z ** 2) + 1e-9
    ux, uy, uz = x / r, y / r, z / r
    # angular shape + published thickness statistics: mean 6.3 mm,
    # sd ~1.5 mm across the vault, thicker occiput
    r_skull_out = skull_radius_mm * (1.0 + 0.05 * ux - 0.03 * uy * uz)
    thick = np.clip(
        6.3 + 1.5 * (0.8 * uz - 0.5 * ux * uy + 0.4 * uy), 3.5, 9.5
    )
    table = np.clip(1.8 + 0.3 * uz, 1.2, 2.4)  # cortical tables ~1.5-2 mm
    d_out = r - r_skull_out
    skin = (d_out > 0) & (d_out <= 5.0)
    outer_table = (d_out <= 0) & (d_out > -table)
    diploe = (d_out <= -table) & (d_out > -(thick - table))
    inner_table = (d_out <= -(thick - table)) & (d_out > -thick)
    brain = d_out <= -thick
    # frontal sinus, placed relative to the skull size
    s = skull_radius_mm / 60.0
    sinus = (
        np.sqrt(x ** 2 + (y + 40 * s) ** 2 + (z - 25 * s) ** 2) < 7
    ) & (brain | diploe | inner_table)

    # the cortical/trabecular split comes from the CT HU inside the bone
    # mask (CT mode quantizes per-HU materials), not from the labels
    labels = np.zeros((n, n, n), np.int32)
    labels[skin] = 5
    bone = outer_table | inner_table | diploe
    labels[bone] = 7
    csf = brain & (d_out > -(thick + 3.0))
    labels[brain] = 2
    labels[csf] = 4
    labels[d_out <= -(thick + 18.0)] = 1
    labels[sinus] = 0  # air cavity

    # water-bath exterior (~20 HU): with a -1000 HU exterior the air
    # extraction would turn the whole coupling path into a reflector
    # mask and no energy would reach the skull; the intracranial sinus
    # stays the air cavity under test
    ct = np.full((n, n, n), 20.0)
    ct[skin] = 45.0 + rng.normal(0, 8, skin.sum())
    ct[brain] = 35.0 + rng.normal(0, 6, brain.sum())
    ct[outer_table] = 1550.0 + rng.normal(0, 180, outer_table.sum())
    ct[inner_table] = 1450.0 + rng.normal(0, 180, inner_table.sum())
    ct[diploe] = 550.0 + rng.normal(0, 140, diploe.sum())
    ct[sinus] = -1000.0
    ct = np.clip(ct, -1000.0, 2100.0)

    # ZTE-like MR: normalized soft-bright / bone-dark / air-dark
    zte = np.full((n, n, n), 600.0)  # water-bath signal, not air-dark
    zte[labels > 0] = 1000.0 + rng.normal(0, 25, int((labels > 0).sum()))
    zte[bone] = 340.0 + rng.normal(0, 40, int(bone.sum()))
    zte[sinus] = 25.0

    # PETRA-like MR: the petra2Density normalization integer-bins the
    # FULL image histogram and divides by the highest-intensity of the
    # two tallest peaks >=50 units apart (`CTZTEProcessing.py:556-577`)
    # -- here the water bath (~600, tallest) and soft tissue (~1000, the
    # normalizer), with bone at norm ~0.35 so the linear law
    # pCT = -2080*norm + 2133.2 lands it near the CT cortical values
    petra = 600.0 + rng.normal(0, 4, (n, n, n))
    petra[labels > 0] = 1000.0 + rng.normal(0, 25, int((labels > 0).sum()))
    petra[bone] = 350.0 + rng.normal(0, 45, int(bone.sum()))
    petra[sinus] = 25.0

    # density volume: soft ~1000, bone via a linear HU law
    dens = np.full((n, n, n), 1000.0)
    dens[bone] = 1000.0 + 0.6 * np.clip(ct[bone], 0, None)
    dens[sinus] = 1.2
    return labels, ct, zte, petra, dens, aff
