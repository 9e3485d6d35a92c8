"""End-to-end pipeline test: Step 1 -> 2 -> 3 on a synthetic head phantom.

The miniature analogue of the reference's `test_full_pipeline_normal`
(SURVEY.md section 4) using a small custom transducer so it runs on the CPU
mesh in tens of seconds.
"""

import numpy as np
import pytest

from babelbrain_tpu.pipeline import load_dict_h5, load_nifti
from babelbrain_tpu.pipeline.profiles import TRANSDUCER_REGISTRY, TransducerSpec
from babelbrain_tpu.pipeline.runner import CaseConfig, run_case
from babelbrain_tpu.pipeline.thermal import SonicationParams


@pytest.fixture(scope="module")
def phantom():
    n = 96
    aff = np.diag([2.0, 2.0, 2.0, 1.0])
    aff[:3, 3] = -96.0
    ii, jj, kk = np.mgrid[0:n, 0:n, 0:n]
    ras = np.stack([ii, jj, kk], -1) * 2.0 - 96.0
    r = np.linalg.norm(ras, axis=-1)
    labels = np.zeros((n, n, n), np.int32)
    labels[r < 46] = 5
    labels[r < 42] = 7
    labels[r < 39] = 4
    labels[r < 36] = 2
    labels[r < 25] = 1
    return labels, aff


@pytest.fixture(scope="module")
def mini_tx():
    TRANSDUCER_REGISTRY["MiniTest"] = TransducerSpec(
        "MiniTest", "single", diameter=20e-3, focal_length=25e-3,
        frequencies=(500e3,),
    )
    return "MiniTest"


@pytest.mark.slow
class TestFullPipeline:
    @pytest.fixture(scope="class")
    def case_result(self, phantom, mini_tx, tmp_path_factory):
        labels, aff = phantom
        out = tmp_path_factory.mktemp("case")
        cfg = CaseConfig(
            tx_system="MiniTest",
            frequency=500e3,
            ppw=6.0,
            output_dir=str(out),
            prefix="phantom",
        )
        return run_case(
            cfg,
            labels,
            aff,
            target_ras=[0, 0, 25],
            direction_ras=[0, 0, -1],
            mask_shape=(64, 64, 104),
            thermal_params=SonicationParams(
                duration_on=2.0, duration_off=2.0, duty_cycle=0.5, isppa=10.0
            ),
        )

    def test_output_files_exist(self, case_result):
        import os

        for k in ("mask", "acoustic", "thermal"):
            assert os.path.isfile(case_result["files"][k]), k
        # display NIfTIs (the reference's OutputFileNames overlay contract,
        # `BabelIntegrationBASE.py:1039-1067`)
        base = case_result["files"]["acoustic"].replace("_DataForSim.h5", "")
        for suffix in ("_FullElasticSolution.nii.gz",
                       "_RayleighFreeWater.nii.gz",
                       "_Water_DataForSim.h5"):
            assert os.path.isfile(base + suffix), suffix
        w = load_dict_h5(base + "_Water_DataForSim.h5")
        assert np.asarray(w["p_amp"]).shape == load_nifti(
            case_result["files"]["mask"]
        ).data.shape
        nii = load_nifti(base + "_FullElasticSolution.nii.gz")
        assert nii.data.shape == load_nifti(
            case_result["files"]["mask"]
        ).data.shape

    def test_mask_contract(self, case_result):
        nii = load_nifti(case_result["files"]["mask"])
        labels = set(np.unique(nii.data.astype(int)))
        assert labels <= {0, 1, 2, 3, 4, 5}
        assert 5 in labels  # target marked
        assert 2 in labels  # skull present

    def test_acoustic_focus_in_brain(self, case_result):
        d = load_dict_h5(case_result["files"]["acoustic"])
        pa = d["p_amp"]
        mm = d["MaterialMap"]
        assert pa.shape == mm.shape
        # the through-skull brain peak should sit near the water-path brain
        # peak (this low-gain mini bowl focuses proximal of the geometric
        # target, in water and tissue alike)
        brain = mm == 4
        pk = np.unravel_index(np.argmax(np.where(brain, pa, 0)), pa.shape)
        pw = np.asarray(d["p_amp_water"])
        pkw = np.unravel_index(np.argmax(np.where(brain, pw, 0)), pw.shape)
        dist_mm = np.linalg.norm(
            (np.array(pk) - np.array(pkw)) * d["SpatialStep"] * 1e3
        )
        assert dist_mm < 8.0
        # transmission through the skull attenuates the field but it's nonzero
        assert np.where(brain, pa, 0).max() > 0.1 * pa.max()

    def test_thermal_metrics(self, case_result):
        t = case_result["thermal"]
        assert t.metrics["TI"] >= 0
        assert t.metrics["TIC"] >= 0
        # with Isppa scaling the focal intensity is normalized: brain peak
        # pressure should give MaxIsppa ~ requested Isppa
        assert t.metrics["MaxIsppa"] == pytest.approx(10.0, rel=0.05)
        assert t.metrics["MI"] > 0
        # skull should heat at least as much as brain (absorption + conduction)
        assert t.metrics["TIC"] > 0.5 * t.metrics["TI"]
        d = load_dict_h5(case_result["files"]["thermal"])
        assert "TI" in d and "CEMBrain" in d and "RatioLosses" in d


@pytest.mark.slow
class TestRefocusing:
    def test_refocus_recovers_aberrated_focus(self):
        """Backpropagation refocusing (S4b/S6-S8) through an aberrating wedge
        should recover focal pressure vs the uncorrected run
        (`BabelIntegrationBASE.py:2372-2399,2562` capability)."""
        import numpy as np
        from babelbrain_tpu.pipeline import build_domain
        from babelbrain_tpu.pipeline.acoustic import (
            position_transducer,
            run_acoustic_sim,
        )
        from babelbrain_tpu.tx import make_focused_bowl

        # fluid media: water + fast wedge
        mats = np.array([[1000.0, 1500.0, 0, 0, 0], [1300.0, 2600.0, 0, 20.0, 0]])
        mask = np.zeros((56, 56, 76), np.uint8)
        mask[28, 28, 42] = 5  # target marker
        dom = build_domain(mask, 500e3, 6.0, materials=mats, water_only=True)
        # insert a wedge aberrator directly into the sim material map:
        # thickness growing along x, placed between source and focus
        mm = dom.material_map
        N1 = mm.shape[0]
        for i in range(N1):
            th = 3 + (9 * i) // N1  # 3..12 cells thick
            mm[i, :, 32 : 32 + th] = 1
        # multi-element concave array: refocusing needs per-element phase
        # degrees of freedom (a single-element bowl cannot correct)
        from babelbrain_tpu.tx import make_concave_array

        F, D = 28e-3, 22e-3
        rng = np.random.default_rng(7)
        n_el = 32
        beta_max = np.arcsin(0.5 * D / F)
        b = np.sqrt(rng.uniform(0.03, 1.0, n_el)) * beta_max
        a = rng.uniform(0, 2 * np.pi, n_el)
        ec = np.stack(
            [F * np.sin(b) * np.cos(a), F * np.sin(b) * np.sin(a),
             -F * np.cos(b)], axis=1,
        )
        tx = make_concave_array(
            500e3, F, 3.2e-3, ec, 1500.0, ppw_surface=2.5
        ).translated([0, 0, F])
        tx = position_transducer(tx, dom, F)

        plain = run_acoustic_sim(dom, tx, 60e3, do_refocus=False)
        refoc = run_acoustic_sim(dom, tx, 60e3, do_refocus=True)
        assert refoc.p_amp_refocus is not None
        assert refoc.phased_array_refocus is not None
        # TargetLocation indexes the exported (mask-frame) arrays directly,
        # like the reference's FocalSpotLocationOrig
        t = np.asarray(plain.data_for_sim["TargetLocation"]).ravel()
        tm = (int(t[0]), int(t[1]), int(t[2]))

        def ball(p):
            return p[
                tm[0] - 3 : tm[0] + 4, tm[1] - 3 : tm[1] + 4, tm[2] - 3 : tm[2] + 4
            ].max()

        gain = ball(refoc.p_amp_refocus) / ball(plain.p_amp)
        assert gain > 1.05  # refocusing recovers focal pressure


@pytest.mark.slow
class TestCTModeCase:
    """CT-mode end-to-end: quantized-HU materials, SDR + AdjustmentInRAS in
    the DataForSim contract (`BabelIntegrationBASE.py:1392` + section 3.2/S10)."""

    @pytest.fixture(scope="class")
    def ct_case(self, phantom, mini_tx, tmp_path_factory):
        labels, aff = phantom
        ct = np.where(
            np.isin(labels, [2, 7]), 1500.0, 40.0
        ) + np.random.default_rng(0).normal(0, 30, labels.shape)
        out = tmp_path_factory.mktemp("ct_case")
        cfg = CaseConfig(
            tx_system="MiniTest",
            frequency=500e3,
            ppw=6.0,
            output_dir=str(out),
            prefix="ct_phantom",
        )
        return run_case(
            cfg,
            labels,
            aff,
            target_ras=[0, 0, 25],
            direction_ras=[0, 0, -1],
            ct_data=ct,
            ct_affine=aff,
            mask_shape=(64, 64, 104),
        )

    def test_sdr_and_adjustment_keys(self, ct_case):
        d = load_dict_h5(ct_case["files"]["acoustic"])
        assert "SDR" in d
        sdr = float(np.asarray(d["SDR"]))
        assert 0.0 <= sdr <= 1.0
        adj = np.asarray(d["AdjustmentInRAS"]).ravel()
        assert adj.shape == (3,)
        # adjustment points along the (negated) trajectory direction
        assert adj[0] == 0 and adj[1] == 0

    def test_field_finite_and_focused(self, ct_case):
        d = load_dict_h5(ct_case["files"]["acoustic"])
        pa = np.asarray(d["p_amp"])
        assert np.isfinite(pa).all()
        assert pa.max() > 0


class TestPositioning:
    def test_position_transducer_reports_adjustment(self):
        from babelbrain_tpu.pipeline import build_domain
        from babelbrain_tpu.pipeline.acoustic import position_transducer
        from babelbrain_tpu.tx import make_focused_bowl

        mats = np.array([[1000.0, 1500.0, 0, 0, 0]])
        mask = np.zeros((48, 48, 64), np.uint8)
        mask[24, 24, 36] = 5
        dom = build_domain(mask, 500e3, 6.0, materials=mats, water_only=True)
        # deep bowl: rim rises above the source plane -> must be pushed down
        tx = make_focused_bowl(500e3, 30e-3, 28e-3, 1500.0, ppw_surface=2)
        tx = tx.translated([0, 0, 30e-3])
        shifted, adj = position_transducer(tx, dom, 30e-3, return_adjustment=True)
        assert adj <= 0.0
        z_plane = dom.z_vec[dom.source_z]
        assert shifted.centers[:, 2].max() <= z_plane + 1e-9
        # consistency with the single-return form
        same = position_transducer(tx, dom, 30e-3)
        np.testing.assert_allclose(same.centers, shifted.centers)


@pytest.mark.slow
class TestInputSourcePlane:
    def test_external_plane_drives_fdtd(self):
        """InputFocusStart parity (`BabelIntegrationSingle.py:306-311`): an
        externally supplied complex source plane replaces the Rayleigh one."""
        from babelbrain_tpu.pipeline import build_domain
        from babelbrain_tpu.pipeline.acoustic import (
            position_transducer,
            run_acoustic_sim,
        )
        from babelbrain_tpu.tx import make_focused_bowl

        mats = np.array([[1000.0, 1500.0, 0, 0, 0]])
        mask = np.zeros((48, 48, 64), np.uint8)
        mask[24, 24, 36] = 5
        dom = build_domain(mask, 500e3, 6.0, materials=mats, water_only=True)
        tx = make_focused_bowl(500e3, 25e-3, 20e-3, 1500.0, ppw_surface=2.5)
        tx = position_transducer(tx.translated([0, 0, 25e-3]), dom, 25e-3)

        ref = run_acoustic_sim(dom, tx, 60e3)
        src = np.asarray(ref.data_for_sim["SourcePlane_re"]) + 1j * np.asarray(
            ref.data_for_sim["SourcePlane_im"]
        )
        full = np.zeros(dom.material_map.shape[:2], np.complex64)
        full[dom.npml : -dom.npml, dom.npml : -dom.npml] = src
        ext = run_acoustic_sim(dom, tx, 60e3, input_source_plane=full)
        # same plane in -> same field out
        np.testing.assert_allclose(ext.p_amp, ref.p_amp, rtol=1e-5, atol=1.0)

        with pytest.raises(ValueError, match="input_source_plane shape"):
            run_acoustic_sim(
                dom, tx, 60e3, input_source_plane=np.zeros((4, 4), np.complex64)
            )


@pytest.mark.slow
class TestZTEPipeline:
    """CTType=ZTE end-to-end: MRI -> pseudo-CT -> CT-mode acoustic run
    (the reference start dialog's ZTE branch, `CTZTEProcessing.py:501-628`)."""

    def test_zte_case(self, phantom, mini_tx, tmp_path):
        labels, aff = phantom
        # synthetic ZTE: bright soft tissue, dark bone, dark background
        rng = np.random.default_rng(0)
        zte = np.full(labels.shape, 30.0)
        zte[labels > 0] = 1000.0
        zte[labels == 2] = 350.0
        zte += rng.normal(0, 5, labels.shape)
        cfg = CaseConfig(
            tx_system="MiniTest", frequency=500e3, ppw=6.0,
            ct_type="ZTE", output_dir=str(tmp_path), prefix="zte",
        )
        res = run_case(
            cfg, labels, aff,
            target_ras=[0, 0, 25], direction_ras=[0, 0, -1],
            ct_data=zte, ct_affine=aff, mask_shape=(64, 64, 104),
        )
        data = res["data_for_sim"]
        # CT mode engaged: per-HU materials present beyond the soft tissues
        assert np.asarray(data["Material"]).shape[0] > 4
        assert "SDR" in data
        # bone pCT maps into a plausible skull HU band
        s1 = res["step1"]
        hu = np.asarray(s1.unique_hu)
        assert hu.min() >= 300.0 and hu.max() <= 2100.0
        assert np.isfinite(np.asarray(data["p_amp"])).all()


@pytest.mark.slow
def test_density_case(phantom, mini_tx, tmp_path):
    """CTType=Density: volume already holds kg/m3; bDensity mapping path
    (`BabelIntegrationBASE.py:1184-1190`)."""
    labels, aff = phantom
    dens = np.full(labels.shape, 1000.0)
    dens[labels == 2] = 1900.0
    cfg = CaseConfig(
        tx_system="MiniTest", frequency=500e3, ppw=6.0,
        ct_type="Density", output_dir=str(tmp_path), prefix="dens",
    )
    res = run_case(
        cfg, labels, aff,
        target_ras=[0, 0, 25], direction_ras=[0, 0, -1],
        ct_data=dens, ct_affine=aff, mask_shape=(64, 64, 104),
    )
    mats = np.asarray(res["data_for_sim"]["Material"])
    # densities pass through as material densities; the resample + median
    # chain smooths the thin 1900 kg/m3 shell somewhat but values must stay
    # in the bone-density band (not HU-like numbers)
    assert 1500.0 < mats[:, 0].max() <= 1900.0
    assert mats[:, 0].min() >= 998.0  # water/soft floor


class TestFileManagerContract:
    """FileManager fidelity (`BabelBrain/FileManager.py:163-293`,
    `BabelBrain.py:1547-1583`): precursor hashes in NIfTI headers,
    cross-target reuse of target-independent products, AdvancedParams
    config-diff invalidation."""

    def test_advanced_params_diff_forces_recalc(self, tmp_path):
        from babelbrain_tpu.pipeline.runner import check_advanced_params

        base = str(tmp_path / "case")
        cfg = CaseConfig(output_dir=str(tmp_path))
        assert check_advanced_params(base, cfg) is False  # first write
        assert check_advanced_params(base, cfg) is False  # unchanged
        cfg2 = CaseConfig(output_dir=str(tmp_path), mapping_method="Aubry")
        assert check_advanced_params(base, cfg2) is True  # physics diff
        assert check_advanced_params(base, cfg2) is False  # re-stored

    def test_verify_precursor(self, tmp_path):
        from babelbrain_tpu.pipeline import save_nifti
        from babelbrain_tpu.pipeline.runner import verify_precursor

        p = str(tmp_path / "x.nii.gz")
        save_nifti(p, np.zeros((4, 4, 4), np.float32), np.eye(4),
                   b"hash:abc123")
        assert verify_precursor(p, "abc123")
        assert not verify_precursor(p, "zzz")
        assert not verify_precursor(str(tmp_path / "missing.nii.gz"), "abc")
        # a replaced (hash-less) file breaks the chain
        save_nifti(p, np.zeros((4, 4, 4), np.float32), np.eye(4))
        assert not verify_precursor(p, "abc123")

    @pytest.mark.slow
    def test_pseudo_ct_reused_across_targets(self, phantom, mini_tx,
                                             tmp_path, monkeypatch):
        """Second target on the same anatomy must reuse the pseudo-CT
        conversion (the reference's cross-target filename substitution,
        `FileManager.py:270-283`)."""
        import babelbrain_tpu.materials.pseudo_ct as pct_mod
        from babelbrain_tpu.pipeline import runner as runner_mod

        calls = {"n": 0}
        real = pct_mod.mri_to_pseudo_ct

        def counting(*a, **k):
            calls["n"] += 1
            return real(*a, **k)

        monkeypatch.setattr(pct_mod, "mri_to_pseudo_ct", counting)
        labels, aff = phantom
        rng = np.random.default_rng(0)
        zte = np.full(labels.shape, 30.0)
        zte[labels > 0] = 1000.0
        zte[labels == 2] = 350.0
        zte += rng.normal(0, 5, labels.shape)
        common = dict(ct_data=zte, ct_affine=aff, mask_shape=(64, 64, 104))
        cfg1 = CaseConfig(tx_system="MiniTest", ct_type="ZTE",
                          output_dir=str(tmp_path), prefix="tgtA")
        run_case(cfg1, labels, aff, target_ras=[0, 0, 25],
                 direction_ras=[0, 0, -1], **common)
        assert calls["n"] == 1
        cfg2 = CaseConfig(tx_system="MiniTest", ct_type="ZTE",
                          output_dir=str(tmp_path), prefix="tgtB")
        run_case(cfg2, labels, aff, target_ras=[0, 4, 25],
                 direction_ras=[0, 0, -1], **common)
        # different target, same anatomy: pseudo-CT conversion NOT re-run
        assert calls["n"] == 1
        # the Step-1 NIfTI carries its precursor hash chain
        from babelbrain_tpu.pipeline import load_nifti as _ln
        import glob
        nif = sorted(glob.glob(str(tmp_path / "tgtA*_BabelViscoInput.nii.gz")))
        assert nif and _ln(nif[0]).descrip.startswith(b"hash:")


@pytest.mark.slow
class TestDomeCase:
    """End-to-end DomeTx-style case through run_case (the reference's
    RUN_SIM dome subclass, `BabelIntegrationDOME_PHASEDARRAY.py:344-407`,
    with dome-specific thermal losses
    `CalculateTemperatureEffects.py:199-201`)."""

    @pytest.fixture(scope="class")
    def dome_case(self, phantom, tmp_path_factory):
        labels, aff = phantom
        F = 16e-3
        TRANSDUCER_REGISTRY["TestDome"] = TransducerSpec(
            "TestDome", "dome", diameter=2 * F, focal_length=F,
            frequencies=(500e3,), n_elements=60, elem_diameter=2.2e-3,
            meta={"amplitude_1w": {"Rayleigh": 0.14,
                                   "Visco": {500000: {6: 60000.0}}}},
        )
        rng = np.random.default_rng(7)
        b = np.arccos(rng.uniform(0.15, 0.95, 60))
        a = rng.uniform(0, 2 * np.pi, 60)
        ec = np.stack(
            [F * np.sin(b) * np.cos(a), F * np.sin(b) * np.sin(a),
             -F * np.cos(b)], axis=1,
        )
        out = tmp_path_factory.mktemp("dome")
        cfg = CaseConfig(
            tx_system="TestDome",
            frequency=500e3,
            ppw=6.0,
            drive_1w=True,
            elem_centers=ec,
            output_dir=str(out),
            prefix="dome",
        )
        res = run_case(
            cfg,
            labels,
            aff,
            target_ras=[0, 0, 25],
            direction_ras=[0, 0, -1],
            mask_shape=(64, 64, 104),
            thermal_params=SonicationParams(
                duration_on=2.0, duration_off=2.0, duty_cycle=0.5,
                isppa=10.0,
            ),
        )
        return res

    def test_outputs_written(self, dome_case):
        import os

        for k in ("mask", "acoustic", "thermal"):
            assert os.path.isfile(dome_case["files"][k]), k
        assert dome_case["acoustic"].meta.get("tx_is_dome") is True

    def test_field_focused_near_target(self, dome_case):
        res = dome_case["acoustic"]
        data = dome_case["data_for_sim"]
        pa = res.p_amp
        t = np.asarray(data["TargetLocation"])
        pk = np.array(np.unravel_index(np.argmax(pa), pa.shape))
        # peak may sit on the dome shell; the target region must still be
        # strongly driven vs the volume median
        tgt_amp = pa[
            max(t[0] - 2, 0):t[0] + 3,
            max(t[1] - 2, 0):t[1] + 3,
            max(t[2] - 2, 0):t[2] + 3,
        ].max()
        assert tgt_amp > 5 * np.median(pa[pa > 0])
        assert np.isfinite(pa).all()

    def test_thermal_used_dome_losses(self, dome_case):
        th = dome_case["thermal"]
        assert th is not None
        assert np.isfinite(th.ratio_losses)
        assert 0 < th.ratio_losses <= 1.5


@pytest.mark.slow
class TestOptimizedWeights:
    """Calibrated per-element weights must flow from the RingAmplPhase h5
    into the drive (the reference's ``OptimizedWeightsFile``,
    `BabelIntegrationBASE.py:2224-2234`)."""

    @pytest.fixture(scope="class")
    def ring_tx(self):
        TRANSDUCER_REGISTRY["MiniRing"] = TransducerSpec(
            "MiniRing", "annular", diameter=20e-3, focal_length=25e-3,
            frequencies=(500e3,),
            in_diameters=(0.0, 10.5e-3, 15.5e-3),
            out_diameters=(10e-3, 15e-3, 20e-3),
            steering_range={"tpo_min": 10e-3, "tpo_max": 40e-3},
            meta={"natural_outplane": 21e-3},
        )
        return "MiniRing"

    def _write_weights(self, path, weights, loc_mm, tx="MiniRing"):
        from babelbrain_tpu.pipeline import save_dict_h5

        save_dict_h5(
            {
                "Amplitudes": np.abs(weights),
                "Phases": np.angle(weights),
                "LocationMM": float(loc_mm),
                "TxSystem": tx,
                "Frequency": 500e3,
            },
            path,
        )

    def test_weights_change_field(self, phantom, ring_tx, tmp_path):
        labels, aff = phantom
        w = np.array([1.0, 0.2 * np.exp(1j * 1.2), 1.5], np.complex64)
        wfile = str(tmp_path / "RingAmplPhase_25.0.h5")
        self._write_weights(wfile, w, 25.0)
        common = dict(
            target_ras=[0, 0, 25], direction_ras=[0, 0, -1],
            mask_shape=(64, 64, 104),
        )
        res_nom = run_case(
            CaseConfig(tx_system=ring_tx, output_dir=str(tmp_path),
                       prefix="nom"),
            labels, aff, **common,
        )
        res_cal = run_case(
            CaseConfig(tx_system=ring_tx, output_dir=str(tmp_path),
                       prefix="cal", optimized_weights_file=wfile),
            labels, aff, **common,
        )
        pa_n = res_nom["acoustic"].p_amp
        pa_c = res_cal["acoustic"].p_amp
        rel = np.abs(pa_c - pa_n).max() / pa_n.max()
        assert rel > 0.05  # calibrated drive produces a different field

class TestOptimizedWeightsLoader:
    """Fast loader-level checks (no simulation)."""

    @pytest.fixture(autouse=True)
    def _spec(self):
        TRANSDUCER_REGISTRY.setdefault(
            "MiniRing",
            TransducerSpec(
                "MiniRing", "annular", diameter=20e-3, focal_length=25e-3,
                frequencies=(500e3,),
                in_diameters=(0.0, 10.5e-3, 15.5e-3),
                out_diameters=(10e-3, 15e-3, 20e-3),
                steering_range={"tpo_min": 10e-3, "tpo_max": 40e-3},
                meta={"natural_outplane": 21e-3},
            ),
        )

    _write_weights = TestOptimizedWeights._write_weights

    def test_auto_picks_nearest_location(self, tmp_path):
        from babelbrain_tpu.pipeline.runner import load_optimized_weights

        spec = TRANSDUCER_REGISTRY["MiniRing"]
        w_near = np.array([1.0, 1.0, 0.5], np.complex64)
        w_far = np.array([0.1, 0.1, 0.1], np.complex64)
        self._write_weights(str(tmp_path / "RingAmplPhase_26.0.h5"),
                            w_near, 26.0)
        self._write_weights(str(tmp_path / "RingAmplPhase_39.0.h5"),
                            w_far, 39.0)
        # z_steering 0.004 -> TPO 25 mm -> nearest file is 26.0
        w = load_optimized_weights(
            "auto", spec, search_dir=str(tmp_path), z_steering=0.004,
            n_elements=3,
        )
        assert np.allclose(w, w_near)

    def test_validation_errors(self, tmp_path):
        from babelbrain_tpu.pipeline.runner import load_optimized_weights

        spec = TRANSDUCER_REGISTRY["MiniRing"]
        bad = str(tmp_path / "RingAmplPhase_20.0.h5")
        self._write_weights(bad, np.ones(5, np.complex64), 20.0)
        with pytest.raises(ValueError, match="5 elements"):
            load_optimized_weights(bad, spec, n_elements=3)
        other = str(tmp_path / "RingAmplPhase_21.0.h5")
        self._write_weights(other, np.ones(3, np.complex64), 21.0,
                            tx="CTX_500")
        with pytest.raises(ValueError, match="calibrated for"):
            load_optimized_weights(other, spec, n_elements=3)


class TestCaseMatrix:
    """run_cases matrix semantics (the reference's RunCases loop,
    `BabelIntegrationBASE.py:884-1037`) with run_case stubbed out."""

    def test_matrix_naming_and_fanout(self, monkeypatch):
        from babelbrain_tpu.pipeline import runner as R

        calls = []

        def fake_run_case(cfg, labels, aff, target, direction, **kw):
            calls.append((cfg.prefix, cfg.frequency, cfg.ppw,
                          tuple(target)))
            return {"files": {}, "cached": False}

        monkeypatch.setattr(R, "run_case", fake_run_case)
        cfg = R.CaseConfig(prefix="sweep")
        out = R.run_cases(
            cfg, None, None,
            {"L-thal": (10, 0, 30), "R-thal": (-10, 0, 30)},
            [0, 0, -1],
            frequencies=[250e3, 500e3], ppws=[6],
        )
        assert len(out) == 4
        assert ("L-thal", 250e3, 6.0) in out
        prefixes = {c[0] for c in calls}
        assert prefixes == {"sweep_L-thal", "sweep_R-thal"}
        freqs = {c[1] for c in calls}
        assert freqs == {250e3, 500e3}

    def test_unnamed_targets_and_error_continuation(self, monkeypatch):
        from babelbrain_tpu.pipeline import runner as R

        def flaky_run_case(cfg, labels, aff, target, direction, **kw):
            if cfg.prefix.endswith("T0"):
                raise RuntimeError("boom")
            return {"ok": True}

        monkeypatch.setattr(R, "run_case", flaky_run_case)
        cfg = R.CaseConfig(prefix="m")
        out = R.run_cases(
            cfg, None, None, [(0, 0, 0), (1, 1, 1)], [0, 0, -1],
        )
        assert isinstance(out[("T0", cfg.frequency, cfg.ppw)], RuntimeError)
        assert out[("T1", cfg.frequency, cfg.ppw)] == {"ok": True}
        with pytest.raises(RuntimeError):
            R.run_cases(
                cfg, None, None, [(0, 0, 0)], [0, 0, -1],
                stop_on_error=True,
            )


@pytest.mark.slow
def test_dome_ct_mode_case(phantom, tmp_path):
    """DomeTx in CT mode through run_case: shear is disabled in CT mode
    (`BabelIntegrationBASE.py:1343-1351`), so the dome drives a FLUID
    medium volumetrically — the reference's heaviest documented workload
    class (670 kHz DomeTx + CT, `README.md:80`). The contract (DataForSim
    with SDR, dome losses in thermal) must hold."""
    labels, aff = phantom
    F = 16e-3
    TRANSDUCER_REGISTRY["TestDomeCT"] = TransducerSpec(
        "TestDomeCT", "dome", diameter=2 * F, focal_length=F,
        frequencies=(500e3,), n_elements=60, elem_diameter=2.2e-3,
    )
    rng = np.random.default_rng(11)
    b = np.arccos(rng.uniform(0.15, 0.95, 60))
    a = rng.uniform(0, 2 * np.pi, 60)
    ec = np.stack(
        [F * np.sin(b) * np.cos(a), F * np.sin(b) * np.sin(a),
         -F * np.cos(b)], axis=1,
    )
    ct = np.where(
        np.isin(labels, [2, 7]), 1500.0, 40.0
    ) + rng.normal(0, 30, labels.shape)
    cfg = CaseConfig(
        tx_system="TestDomeCT",
        frequency=500e3,
        ppw=6.0,
        elem_centers=ec,
        output_dir=str(tmp_path),
        prefix="domect",
    )
    res = run_case(
        cfg, labels, aff,
        target_ras=[0, 0, 25], direction_ras=[0, 0, -1],
        ct_data=ct, ct_affine=aff,
        mask_shape=(64, 64, 104),
        thermal_params=SonicationParams(
            duration_on=1.0, duration_off=1.0, duty_cycle=0.5, isppa=8.0,
        ),
    )
    d = res["data_for_sim"]
    assert "SDR" in d  # CT-mode contract
    assert res["acoustic"].meta.get("tx_is_dome") is True
    pa = res["acoustic"].p_amp
    assert np.isfinite(pa).all() and pa.max() > 0
    th = res["thermal"]
    assert th is not None and np.isfinite(th.ratio_losses)


@pytest.mark.slow
def test_run_cases_end_to_end_caching(phantom, mini_tx, tmp_path):
    """run_cases over two targets: per-case files get distinct names, and a
    repeat sweep serves every cell from the hash caches (RunCases
    skip-if-exists parity, `BabelIntegrationBASE.py:962-966`)."""
    import os

    from babelbrain_tpu.pipeline.runner import run_cases

    labels, aff = phantom
    cfg = CaseConfig(tx_system=mini_tx, output_dir=str(tmp_path),
                     prefix="mx")
    targets = {"A": [0, 0, 25], "B": [0, 4, 25]}
    common = dict(mask_shape=(64, 64, 104))
    r1 = run_cases(cfg, labels, aff, targets, [0, 0, -1], **common)
    assert set(r1) == {("A", cfg.frequency, cfg.ppw),
                       ("B", cfg.frequency, cfg.ppw)}
    for (tn, _, _), res in r1.items():
        assert not isinstance(res, Exception), res
        assert not res["cached"]
        assert f"mx_{tn}_" in res["files"]["acoustic"]
        assert os.path.isfile(res["files"]["acoustic"])
    r2 = run_cases(cfg, labels, aff, targets, [0, 0, -1], **common)
    assert all(res["cached"] for res in r2.values())


def test_shape_bucket_shares_executable():
    """Shape bucketing + the in-process executable memo: two near-equal
    cases collapse to one canonical grid signature and the second
    ``run_fdtd`` call reuses the first call's compiled executable (the
    reference's case loop is compile-free,
    `BabelIntegrationBASE.py:884-1037`; every distinct shape costs a
    fresh FDTD compilation)."""
    import numpy as np

    from babelbrain_tpu.ops.fdtd import (
        FDTDGrid,
        fdtd_executable_stats,
        run_fdtd,
        stable_dt,
    )
    from babelbrain_tpu.pipeline.domain import build_domain

    # near-equal masks from two "targets" -> one bucketed signature
    m1 = np.zeros((30, 28, 41), np.uint32)
    m2 = np.zeros((27, 31, 38), np.uint32)
    for m in (m1, m2):
        m[4:-4, 4:-4, 18:24] = 2
        m[m.shape[0] // 2, m.shape[1] // 2, 30] = 5
    d1 = build_domain(m1, 500e3, 6.0, npml=4, shape_bucket=32)
    d2 = build_domain(m2, 500e3, 6.0, npml=4, shape_bucket=32)
    assert d1.material_map.shape == d2.material_map.shape
    assert d1.n_steps == d2.n_steps
    # bucket padding must be stripped again by crop()
    assert d1.crop(np.zeros(d1.material_map.shape)).shape == m1.shape
    assert d2.crop(np.zeros(d2.material_map.shape)).shape == m2.shape

    # identical grid signature + different field data -> one build, one hit
    F0, C = 500e3, 1500.0
    dx = C / F0 / 6
    ppp = int(np.ceil(1 / F0 / stable_dt(dx, C, 0.5)))
    dt = 1 / F0 / ppp
    ns = 2 * ppp
    grid = FDTDGrid(shape=(16, 16, 32), dx=dx, dt=dt, n_steps=ns,
                    frequency=F0, npml=4, sensor_start=ns - ppp,
                    source_plane_z=5)
    mats = np.array([[1000.0, C, 0.0, 0.0, 0.0]])
    amp = np.zeros((16, 16), np.float32)
    amp[4:-4, 4:-4] = 60e3
    fdtd_executable_stats(reset=True)
    run_fdtd(np.zeros((16, 16, 32), np.uint8), mats, grid, source_amp=amp)
    run_fdtd(np.zeros((16, 16, 32), np.uint8), mats, grid,
             source_amp=amp * 0.5)
    stats = fdtd_executable_stats()
    assert stats["builds"] == 1
    assert stats["hits"] == 1
