"""Realistic digital-head validation corpus.

The reference's regression tests drive real Zenodo datasets through the
full pipeline (SURVEY.md section 4; doi 10.5281/zenodo.7894431). No
network access exists here, so the closest offline substitute is the
procedural head phantom of ``pipeline.phantom`` (published cranial
statistics), driven through the CT, ZTE, PETRA and Density imaging paths
end to end.

Cross-modality consistency (focal position and pressure within tiers) is
the validation: the three imaging paths describe the SAME head, so the
simulated fields must agree. The CT-mode field is additionally
regression-pinned against a golden (tol_1 on focal metrics, tol_5 on the
field), regenerable with BBT_GENERATE_GOLDEN=1.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from babelbrain_tpu.pipeline.phantom import build_head
from babelbrain_tpu.pipeline.profiles import (
    TRANSDUCER_REGISTRY,
    TransducerSpec,
)
from babelbrain_tpu.pipeline.runner import CaseConfig, run_case

GOLDEN = Path(__file__).parent / "golden" / "digital_head_ct.npz"
GENERATE = os.environ.get("BBT_GENERATE_GOLDEN") == "1"

pytestmark = pytest.mark.slow

N = 96
VOX = 2.0


@pytest.fixture(scope="module")
def head():
    return build_head(n=N, voxel_mm=VOX, skull_radius_mm=60.0)


@pytest.fixture(scope="module")
def head_tx():
    TRANSDUCER_REGISTRY["HeadTest"] = TransducerSpec(
        "HeadTest", "single", diameter=30e-3, focal_length=55e-3,
        frequencies=(500e3,),
    )
    return "HeadTest"


def _run_mode(head, tx, tmpdir, ct_type, vol):
    labels, ct, zte, petra, dens, aff = head
    cfg = CaseConfig(
        tx_system=tx, frequency=500e3, ppw=6.0, ct_type=ct_type,
        output_dir=str(tmpdir), prefix=f"dh_{ct_type.lower()}",
    )
    return run_case(
        cfg, labels, aff,
        target_ras=[0.0, 0.0, 20.0], direction_ras=[0, 0, -1],
        ct_data=vol, ct_affine=aff, mask_shape=(84, 84, 192),
    )


def _focal_metrics(res):
    import babelbrain_tpu.pipeline.io as pio

    return focal_metrics(pio.load_dict_h5(res["files"]["acoustic"]))


def run_ct_case(head, tx, outdir, write_h5=True):
    """The CT-mode case the golden pins (HeadTest bowl, 84x84x192 grid)."""
    labels, ct, zte, petra, dens, aff = head
    cfg = CaseConfig(
        tx_system=tx, frequency=500e3, ppw=6.0, ct_type="CT",
        output_dir=str(outdir), prefix="dh_ct",
    )
    return run_case(
        cfg, labels, aff,
        target_ras=[0.0, 0.0, 20.0], direction_ras=[0, 0, -1],
        ct_data=ct, ct_affine=aff, mask_shape=(84, 84, 192),
        write_h5=write_h5,
    )


def golden_crop(pa):
    """Central field crop stored in the golden."""
    c = tuple(s // 2 for s in pa.shape)
    return pa[c[0] - 16:c[0] + 16, c[1] - 16:c[1] + 16,
              c[2] - 24:c[2] + 24].astype(np.float32)


def golden_errors(data):
    """(peak rel. error, focus shift mm, crop rel-L2) vs the golden for a
    DataForSim dict of the CT case."""
    pa, pos, pk, _ = focal_metrics(data)
    g = np.load(GOLDEN)
    gcrop = np.asarray(g["crop"])
    l2 = np.linalg.norm(golden_crop(pa) - gcrop) / (
        np.linalg.norm(gcrop) + 1e-9)
    return (abs(pk - float(g["peak"])) / float(g["peak"]),
            float(np.linalg.norm(pos - g["pos"])), float(l2))


def focal_metrics(d):
    pa = np.asarray(d["p_amp"])
    pk = np.unravel_index(np.argmax(pa), pa.shape)
    xv = np.asarray(d["x_vec"])
    yv = np.asarray(d["y_vec"])
    zv = np.asarray(d["z_vec"])
    pos = np.array([xv[pk[0]], yv[pk[1]], zv[pk[2]]])
    vol6 = float((pa >= pa.max() / 2).sum())
    return pa, pos, float(pa.max()), vol6


class TestDigitalHead:
    @pytest.fixture(scope="class")
    def runs(self, head, head_tx, tmp_path_factory):
        out = {}
        labels, ct, zte, petra, dens, aff = head
        base = tmp_path_factory.mktemp("digital_head")
        out["CT"] = _run_mode(head, head_tx, base, "CT", ct)
        out["ZTE"] = _run_mode(head, head_tx, base, "ZTE", zte)
        out["PETRA"] = _run_mode(head, head_tx, base, "PETRA", petra)
        out["Density"] = _run_mode(head, head_tx, base, "Density", dens)
        return out

    def test_all_modes_complete_with_ct_materials(self, runs):
        for mode, res in runs.items():
            data = res["data_for_sim"]
            assert np.isfinite(np.asarray(data["p_amp"])).all(), mode
            # per-HU material list engaged in every imaging mode
            assert np.asarray(data["Material"]).shape[0] > 4, mode
            assert "SDR" in data, mode

    def test_modes_agree_on_focus(self, runs):
        """The imaging paths describe one head: focal positions
        within 6 mm (3 voxels) and peak pressures within 35% (the
        pseudo-CT/density laws are approximations of the CT truth, not
        reparameterizations — the reference quotes similar ZTE-vs-CT
        spreads for transcranial pressure)."""
        metrics = {m: _focal_metrics(r) for m, r in runs.items()}
        _, pos_ct, pk_ct, _ = metrics["CT"]
        for mode in ("ZTE", "PETRA", "Density"):
            _, pos, pk, _ = metrics[mode]
            assert np.linalg.norm(pos - pos_ct) <= 6.0, (mode, pos, pos_ct)
            assert abs(pk - pk_ct) / pk_ct <= 0.35, (mode, pk, pk_ct)

    def test_skull_statistics_realistic(self, head):
        """The phantom's skull HU distribution spans the published adult
        range the Webb tables cover (`materials/data/webb_tables.npz`)."""
        labels, ct, _, _, _, _ = head
        bone_hu = ct[labels == 7]
        assert 300 < np.median(bone_hu) < 1800
        assert bone_hu.max() <= 2100.0
        q10, q90 = np.quantile(bone_hu, (0.1, 0.9))
        assert q90 - q10 > 500  # bimodal table/diploe spread, not a slab

    def test_ct_mode_regression_golden(self, runs):
        """tol_1 on focal metrics / tol_5 on the field vs the stored
        golden (the reference's tolerance-tier scheme, `pytest.ini:44-61`)."""
        pa, pos, pk, vol6 = _focal_metrics(runs["CT"])
        # compact golden: central field crop + metrics
        crop = golden_crop(pa)
        if GENERATE:
            GOLDEN.parent.mkdir(exist_ok=True)
            np.savez_compressed(
                GOLDEN, crop=crop, pos=pos, peak=pk, vol6=vol6
            )
            pytest.skip("golden regenerated")
        if not GOLDEN.exists():
            pytest.fail(
                "golden missing: run BBT_GENERATE_GOLDEN=1 pytest "
                "tests/test_digital_head.py"
            )
        g = np.load(GOLDEN)
        assert abs(pk - float(g["peak"])) / float(g["peak"]) < 0.01  # tol_1
        assert np.linalg.norm(pos - g["pos"]) < VOX  # same voxel
        gcrop = np.asarray(g["crop"])
        l2 = np.linalg.norm(crop - gcrop) / (np.linalg.norm(gcrop) + 1e-9)
        assert l2 < 0.05  # tol_5 on the field
