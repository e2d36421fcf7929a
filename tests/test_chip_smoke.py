"""chip_smoke.py: refuses to run without a GPU, and its phases rehearsed at
tiny size on the CPU (kernels in interpret mode)."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _run(cwd, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_exits_nonzero_without_a_gpu():
    r = _run(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_exits_nonzero_outside_the_repository(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("phase", ["pipeline", "service", "ba", "matcher"])
def test_rehearsed_phase_passes(phase, tmp_path, capsys):
    assert chip_smoke.main(["--rehearse", "--phases", phase,
                            "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith(f"{phase} [")
    assert '"ok"' not in out[-1]


def test_rehearsed_four_device_paths(tmp_path, capsys):
    assert chip_smoke.main(["--rehearse", "--cards", "4",
                            "--out", str(tmp_path)]) == 0
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith("cards [")
