"""Placement planning (PlanTUS-equivalent) + O'Neil analytic anchors."""

import numpy as np
import pytest

from babelbrain_tpu.pipeline.plantus import (
    PlanTUSConfig,
    acoustic_axis_oneil,
    export_placements_csv,
    find_tpo_equivalent,
    metric_volume,
    suggest_placements,
)
from babelbrain_tpu.pipeline.step1 import LABELS


class TestONeil:
    def test_peak_near_focus_and_flhm(self):
        h, tpo, flhm = find_tpo_equivalent(500e3, 64e-3, 63.2e-3)
        # diffraction shifts the axial peak slightly pre-focal
        assert 0 < tpo + h < 63.2e-3
        assert 63.2e-3 - (tpo + h) < 10e-3
        assert 5e-3 < flhm < 40e-3

    def test_oneil_matches_rayleigh_on_axis(self):
        """The blocked-matmul Rayleigh propagator must reproduce the O'Neil analytic
        on-axis magnitude of a spherical shell (normalized)."""
        from babelbrain_tpu.ops.rayleigh import rayleigh_field
        from babelbrain_tpu.tx import make_focused_bowl

        F0, c, F, D = 500e3, 1500.0, 63.2e-3, 64e-3
        h, z, p_an = acoustic_axis_oneil(F0, D, F, c=c)
        tx = make_focused_bowl(F0, F, D, c, ppw_surface=6.0)
        # bowl focus at origin, apex at z=-F; O'Neil z is measured from apex
        sel = (z > 0.3 * F) & (z < 1.6 * F)
        pts = np.zeros((sel.sum(), 3), np.float32)
        pts[:, 2] = z[sel] - F
        k = 2 * np.pi * F0 / c
        u0 = np.ones(tx.centers.shape[0], np.complex64)
        p_num = np.abs(np.asarray(rayleigh_field(k, tx.centers, tx.areas, u0, pts)))
        a = p_an[sel] / p_an[sel].max()
        b = p_num / p_num.max()
        # normalized axial profiles agree to a few % of peak
        np.testing.assert_allclose(b, a, atol=0.04)


@pytest.fixture(scope="module")
def sphere_head():
    """Synthetic head: concentric skin/skull/brain spheres, 1 mm grid."""
    n = 96
    lab = np.zeros((n, n, n), np.uint8)
    c = np.array([n / 2, n / 2, n / 2])
    ii = np.indices(lab.shape).astype(np.float64)
    r = np.sqrt(((ii - c[:, None, None, None]) ** 2).sum(0))
    lab[r < 40] = LABELS["skin"]
    lab[r < 37] = LABELS["cortical"]
    lab[r < 32] = LABELS["brain"]
    affine = np.eye(4)  # 1 mm, RAS == voxel
    return lab, affine, c


class TestPlacement:
    def test_ranked_placements_on_sphere(self, sphere_head):
        lab, affine, c = sphere_head
        target = c + np.array([0.0, 0.0, 18.0])  # off-center target
        cfg = PlanTUSConfig(
            max_distance=80.0, min_distance=5.0, optimal_distance=25.0,
            transducer_diameter=64.0, max_angle=20.0,
        )
        res = suggest_placements(lab, affine, target, cfg, top_k=5)
        assert len(res.positions_ras) == 5
        # the best entry should sit on the near pole (shortest path ~21mm,
        # close to optimal 25mm, radial incidence): +z side of the sphere
        best = res.positions_ras[0]
        assert best[2] > c[2] + 30
        # direction points at the target
        d = res.directions_ras[0]
        expect = target - best
        expect /= np.linalg.norm(expect)
        np.testing.assert_allclose(d, expect, atol=1e-6)
        # radial rays through a 5-mm shell: thickness metric in range
        i_best = res.order[0]
        th = res.metrics["skull_thickness"][i_best]
        assert 4.0 <= th <= 9.0
        # trajectory matrix contract: target in translation, -z = direction
        M = res.trajectory(0)
        np.testing.assert_allclose(M[:3, 3], target)
        np.testing.assert_allclose(-M[:3, 2], d, atol=1e-12)

    def test_tilt_and_envelope_filters(self, sphere_head):
        lab, affine, c = sphere_head
        target = c.copy()
        cfg = PlanTUSConfig(
            max_distance=41.0, min_distance=39.0, optimal_distance=40.0,
            transducer_diameter=64.0, max_angle=5.0,
        )
        res = suggest_placements(lab, affine, target, cfg, top_k=3)
        # center target: every scalp point is ~40mm away and radial
        assert np.all(np.abs(res.metrics["skin_target_distance"] - 40.0) < 2)
        with pytest.raises(ValueError):
            suggest_placements(
                lab, affine, target,
                PlanTUSConfig(
                    max_distance=10.0, min_distance=5.0, optimal_distance=8.0,
                    transducer_diameter=64.0, max_angle=20.0,
                ),
            )

    def test_metric_volume_and_csv(self, sphere_head, tmp_path):
        lab, affine, c = sphere_head
        cfg = PlanTUSConfig(
            max_distance=80.0, min_distance=5.0, optimal_distance=25.0,
            transducer_diameter=64.0, max_angle=25.0,
        )
        res = suggest_placements(lab, affine, c + [0, 0, 10.0], cfg)
        vol = metric_volume(lab, affine, res, "score")
        assert np.isfinite(vol).sum() == len(res.candidates_ras)
        f = str(tmp_path / "placements.csv")
        export_placements_csv(f, res)
        rows = open(f).read().strip().splitlines()
        assert len(rows) == 1 + len(res.positions_ras)
        assert rows[0].startswith("rank,x,y,z")

    def test_recommended_focal_setting(self):
        from babelbrain_tpu.pipeline.plantus import recommended_focal_setting

        cfg = PlanTUSConfig(
            max_distance=80.0, min_distance=30.0, optimal_distance=55.0,
            transducer_diameter=65.0, max_angle=15.0, plane_offset=9.5,
            focal_distance_list=[40.0, 60.0, 80.0], flhm_list=[18.0, 25.0, 33.0],
        )
        rec = recommended_focal_setting(cfg, 50.0)
        assert rec["focal_depth_mm"] == 59.5
        assert rec["in_envelope"]
        assert 24.0 < rec["expected_flhm_mm"] < 26.0
        # out-of-envelope clamps + flags
        rec = recommended_focal_setting(cfg, 100.0)
        assert rec["focal_depth_mm"] == 80.0
        assert not rec["in_envelope"]
        # generic-model fallback (no calibration lists)
        cfg2 = PlanTUSConfig(
            max_distance=80.0, min_distance=30.0, optimal_distance=55.0,
            transducer_diameter=65.0, max_angle=15.0,
        )
        rec = recommended_focal_setting(cfg2, 55.0)
        assert 5.0 < rec["expected_flhm_mm"] < 40.0

    def test_yaml_config_contract(self, tmp_path):
        import yaml

        cfg = PlanTUSConfig(
            max_distance=80.0, min_distance=30.0, optimal_distance=55.0,
            transducer_diameter=65.0, max_angle=15.0, plane_offset=9.5,
            additional_offset=2.0, focal_distance_list=[40.0, 60.0, 80.0],
            flhm_list=[18.0, 25.0, 33.0],
        )
        f = str(tmp_path / "tx.yaml")
        cfg.export_yaml(f)
        back = yaml.safe_load(open(f))
        # the reference's PlanTUS config key set (`RunPlanTUS.py:161-184`)
        for key in (
            "max_distance", "min_distance", "optimal_distance",
            "transducer_diameter", "max_angle", "plane_offset",
            "additional_offset", "focal_distance_list", "flhm_list",
            "weight_skin_target_distances", "weight_skull_thickness",
        ):
            assert key in back
        assert back["flhm_list"] == [18.0, 25.0, 33.0]


class TestGifti:
    def test_surf_func_roundtrip(self, tmp_path):
        """GIfTI surface + metric round-trip (the `*.surf.gii` /
        `*.func.gii` interchange PlanTUS workflows use,
        `RunPlanTUS.py:338,492,541-545`), including the POINTSET
        coordinate transform."""
        from babelbrain_tpu.pipeline import gifti

        rng = np.random.default_rng(0)
        verts = rng.normal(size=(50, 3)).astype(np.float32) * 40
        faces = rng.integers(0, 50, (80, 3)).astype(np.int32)
        p = str(tmp_path / "scalp.surf.gii")
        gifti.write_surf_gii(p, verts, faces)
        v2, f2 = gifti.read_surf_gii(p)
        np.testing.assert_allclose(v2, verts, atol=1e-6)
        np.testing.assert_array_equal(f2, faces)

        # non-identity transform applied on read
        xf = np.eye(4)
        xf[:3, 3] = (5.0, -3.0, 2.0)
        gifti.write_surf_gii(p, verts, faces, transform=xf)
        v3, _ = gifti.read_surf_gii(p)
        np.testing.assert_allclose(v3, verts + xf[:3, 3], atol=1e-4)

        vals = rng.normal(size=50).astype(np.float32)
        q = str(tmp_path / "score.func.gii")
        gifti.write_func_gii(q, vals, name="score")
        np.testing.assert_allclose(gifti.read_func_gii(q), vals, atol=0)

        # multi-column metric files
        vals2 = rng.normal(size=(50, 3)).astype(np.float32)
        gifti.write_func_gii(q, vals2)
        np.testing.assert_allclose(gifti.read_func_gii(q), vals2, atol=0)

    def test_planner_accepts_gifti_scalp_mesh(self, sphere_head, tmp_path):
        """End-to-end: extract the scalp surface to .surf.gii, plan with
        the MESH as the candidate set, and write a per-vertex metric
        map; mesh-based placements must agree with the voxel-based ones."""
        from babelbrain_tpu.pipeline import gifti
        from babelbrain_tpu.pipeline.plantus import (
            export_metric_func_gii,
            export_scalp_surf_gii,
        )

        lab, affine, c = sphere_head
        surf = str(tmp_path / "scalp.surf.gii")
        verts, faces = export_scalp_surf_gii(surf, lab, affine)
        # the extracted scalp should be a sphere of radius ~40 around c
        r = np.linalg.norm(verts - c, axis=1)
        assert 37 < np.median(r) < 42

        target = c + np.array([0.0, 0.0, 18.0])
        cfg = PlanTUSConfig(
            max_distance=80.0, min_distance=5.0, optimal_distance=25.0,
            transducer_diameter=64.0, max_angle=20.0,
        )
        mesh = gifti.read_surf_gii(surf)
        res_m = suggest_placements(
            lab, affine, target, cfg, top_k=5, scalp_mesh=mesh
        )
        res_v = suggest_placements(lab, affine, target, cfg, top_k=5)
        # best entry points agree to within a couple of voxels
        assert np.linalg.norm(
            res_m.positions_ras[0] - res_v.positions_ras[0]
        ) < 4.0

        fmap = str(tmp_path / "score.func.gii")
        vals = export_metric_func_gii(fmap, res_m, len(mesh[0]))
        back = gifti.read_func_gii(fmap)
        assert back.shape == (len(mesh[0]),)
        finite = np.isfinite(back)
        assert finite.sum() == len(res_m.metrics["score"])
        np.testing.assert_allclose(
            back[finite], res_m.metrics["score"], atol=1e-6
        )
        assert np.array_equal(np.isfinite(vals), finite)
