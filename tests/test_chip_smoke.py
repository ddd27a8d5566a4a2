"""The card harnesses rehearsed on the CPU.

Every phase of ``chip_smoke.py`` runs here at its ``--rehearse`` sizes, and
``bench.py`` / ``chip_smoke.py`` must refuse to run on a CPU backend without
``--rehearse``: no path falls back to the CPU and reports a device number.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _cpu_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return env


@pytest.mark.parametrize("phase", ["0", "2", "3", "4", "5", "6"])
def test_chip_smoke_phase_rehearsal(phase, capsys):
    chip_smoke.PHASES[phase](chip_smoke.REHEARSE, True)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[phase {phase}] ")
    json.loads(line.split("] ", 1)[1])


def test_chip_smoke_native_build_rehearsal(tmp_path, capsys):
    # built outside the package, so that no other test's engine changes
    chip_smoke.phase1_native(chip_smoke.REHEARSE, True,
                             out=tmp_path / "libscxnative.so")
    assert (tmp_path / "libscxnative.so").exists()
    assert '"native_available": true' in capsys.readouterr().out


def test_chip_smoke_four_card_rehearsal(capsys):
    """The four-card phase on four of conftest's eight CPU devices."""
    chip_smoke.phase_four_cards(chip_smoke.REHEARSE, True)
    out = capsys.readouterr().out
    fields = json.loads(out.strip().splitlines()[-1].split("] ", 1)[1])
    assert fields["mesh"] == "4x1"
    assert fields["identical_bases"] or fields["max_rel_obj_diff"] <= 1e-9


def test_phase_failure_raises():
    with pytest.raises(chip_smoke.PhaseFailed, match="boom"):
        chip_smoke.check(False, "boom")


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_card_scripts_refuse_the_cpu(script):
    r = subprocess.run([sys.executable, script], cwd=REPO, env=_cpu_env(),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "metric" not in r.stdout


def test_bench_rehearsal_labels_the_cpu():
    r = subprocess.run([sys.executable, "bench.py", "--rehearse"], cwd=REPO,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["metric"] == "certified_exact_ot_crossover_throughput"
    assert out["detail"]["platform"] == "cpu"
    assert all(row["all_certified"] for row in out["detail"]["rows"])


def test_chip_smoke_alone_fails(tmp_path):
    """Copied into a directory that holds nothing else of the repo, the
    script exits non-zero and prints no result line."""
    (tmp_path / "chip_smoke.py").write_text(
        open(os.path.join(REPO, "chip_smoke.py")).read())
    env = _cpu_env()
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
