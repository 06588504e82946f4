"""chip_smoke.py refuses to run without a GPU: non-zero exit, no result
line, nothing built."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def test_chip_smoke_refuses_cpu(tmp_path):
    data = tmp_path / "data"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py"), "--data-dir", str(data)],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr
    assert not data.exists()
