"""``chip_smoke.py`` on the CPU: its phases at tiny budgets with the
CPU-vs-CPU comparisons wired through, and its refusal to run without a GPU.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
from conditional_ude_tpu.fit.train import TrainConfig  # noqa: E402

TINY = chip_smoke.Sizes(
    train=TrainConfig(initial_guesses=48, selected_initials=3,
                      adam_iters=4, lbfgs_iters=4, max_steps=64,
                      screen_chunk=48),
    reestimate_iters=8, census_steps=24, screen_samples=12,
    census_samples=6, mesh_iters=2)


@pytest.fixture(scope="module")
def splits():
    """exp02's fit split and the test split, cut to a few subjects."""
    fit, test = chip_smoke.load_cohorts()
    assert (len(fit.ages), len(test.ages)) == (57, 35)
    return fit.subset(np.arange(6)), test.subset(np.arange(5))


@pytest.fixture(scope="module")
def model():
    return chip_smoke.flagship_model()


def test_flagship_model_has_published_widths(model):
    assert model.net.num_params == 37
    assert model.net.input_dims == 2


def test_phase_flagship_tiny(model, splits, capsys):
    res = chip_smoke.phase_flagship(model, splits[0], TINY)
    out = capsys.readouterr().out
    assert res.objectives.shape == (3,)
    assert res.timings["refine_path"] == "xla_reverse_ad"
    for name in ("screen losses", "final Tsit5 objectives",
                 "NN gradient at best restart", "value at best screened"):
        assert f"check {name}" in out


def test_phase_reestimate_and_census_tiny(model, splits, capsys):
    nn = model.net.init(jax.random.key(1))
    betas = np.linspace(-1.5, -0.5, 6, dtype=np.float32)[:, None]
    b, s, bounds = chip_smoke.phase_reestimate(model, nn, betas, splits[1],
                                               TINY)
    assert b.shape == s.shape == (5,)
    assert bounds == chip_smoke.reestimation_bounds(betas)
    prof = chip_smoke.phase_census(model, nn, s, bounds, splits[1], TINY)
    assert prof.values.shape == (5, 24)
    out = capsys.readouterr().out
    assert "check re-estimated objectives" in out
    assert "check census (6 grid points x 5 subjects)" in out


def test_phase_four_cards_on_virtual_mesh(model, splits, capsys):
    chip_smoke.phase_four_cards(model, splits[0], splits[1], TINY)
    out = capsys.readouterr().out
    assert "check mesh vs card-0 screen losses" in out
    assert "check mesh vs card-0 re-estimated objectives" in out


def test_check_raises_outside_tolerance():
    chip_smoke.check("same", [1.0, np.inf], [1.0 + 1e-6, np.inf], 1e-5, "ok")
    with pytest.raises(AssertionError):
        chip_smoke.check("off", [1.0], [1.1], 1e-3, "must fail")
    chip_smoke.check_normwise("near", [1.0, 0.01], [1.0, 0.0], 1e-3, 1e-2,
                              "within atol")
    with pytest.raises(AssertionError):
        chip_smoke.check_normwise("off", [1.0, 0.0], [1.0, 0.5], 1e-3, 0.0,
                                  "must fail")


def test_main_without_gpu_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_exits_nonzero(tmp_path):
    """A directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120,
                       env={**{k: v for k, v in os.environ.items()
                               if k != "PYTHONPATH"}, "JAX_PLATFORMS": "cpu"})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
