"""chip_smoke.py's phases at a tiny size on the CPU (the script itself
refuses to run without a GPU)."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import jax

import chip_smoke as cs

REPO = Path(__file__).resolve().parent.parent


def test_smoke_resolve_parity_tiny():
    out = cs.resolve_parity(cs.TINY, interpret=True)
    assert set(out) == {"oblique", "nadir", "distorted"}
    for res in out.values():
        assert res["covered_px"] > 0
        assert res["distinct_ids_cpu_ref"] > 100
        assert abs(res["distinct_ids"] - res["distinct_ids_cpu_ref"]) <= (
            res["flipped_px_vs_cpu_ref"]
        )


def test_smoke_aggregate_tiny(tmp_path):
    out = cs.aggregate_phase(cs.TINY, cs.write_survey(cs.TINY, tmp_path))
    assert out["route"] == "streaming"  # tiny surveys skip the planner
    assert out["counts_exact"] and out["counted_px"] > 0
    assert out["faces_seen"] > 0 and out["max_fraction_err"] <= 1e-5


def test_smoke_render_tiny(tmp_path):
    survey = cs.write_survey(cs.TINY, tmp_path / "survey")
    out = cs.render_phase(cs.TINY, survey, tmp_path / "renders")
    assert set(out) == {"view0_differ_share", "view1_differ_share"}


def test_smoke_four_cards_tiny(tmp_path):
    survey = cs.write_survey(cs.TINY, tmp_path)
    out = cs.four_card_phase(cs.TINY, survey, jax.devices()[:4])
    assert out["devices"] == 4 and out["views_counts_equal"]
    assert out["faces_seen"] > 0


def test_smoke_refuses_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_smoke_alone_refuses_cpu(tmp_path):
    """Copied out of the repository and run without a GPU, the script
    exits non-zero and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu",
             "HOME": str(tmp_path)},
    )
    assert r.returncode != 0
    assert not any(
        line.startswith("{") and json.loads(line).get("ok")
        for line in r.stdout.splitlines()
    )
