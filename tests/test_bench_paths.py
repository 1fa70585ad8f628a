"""Regression guards for ``scripts/ess32.py`` (north star #2; bench.py calls
its ``measure`` in-process): the pinned and growth modes run end to end as a
command-line script, on CPU."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_ess32(extra_env, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env.pop("ISING_ESS_CHUNK", None)
    env.pop("ISING_ESS_NOPIN", None)
    env.update(extra_env)
    return subprocess.run(
        [sys.executable, "scripts/ess32.py", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )


def test_ess32_pinned_mode_prints_parseable_ess(tmp_path):
    out = _run_ess32({"ISING_ESS_PIN": "96,256,256"}, ["4", "8", "8", "2", "2"])
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if "ESS/s=" in ln]
    assert lines, out.stdout
    # bench.py's parser: float(line.split("ESS/s=")[1].split()[0])
    ess = float(lines[0].split("ESS/s=")[1].split()[0])
    assert ess > 0


def test_ess32_discovery_persists_pin_then_pinned_reuses_it(tmp_path):
    pin_file = str(tmp_path / "pins.json")
    env = {"ISING_ESS_PIN_FILE": pin_file, "ISING_ESS_NOPIN": "1",
           "ISING_ESS_CHUNK": "2"}
    out = _run_ess32(env, ["4", "8", "8", "1", "1"])
    assert out.returncode == 0, out.stderr[-2000:]
    pins = json.load(open(pin_file))
    assert "4,8" in pins and len(pins["4,8"]) == 3
    # Pinned reuse: same file, no NOPIN -> pinned banner + a clean row.
    out2 = _run_ess32({"ISING_ESS_PIN_FILE": pin_file}, ["4", "8", "8", "2", "2"])
    assert out2.returncode == 0, out2.stderr[-2000:]
    assert "(pinned:" in out2.stderr
    assert any("ESS/s=" in ln for ln in out2.stdout.splitlines())
