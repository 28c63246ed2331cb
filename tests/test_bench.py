"""bench.py measures on an NVIDIA GPU only: without one it must exit
non-zero and print no result."""

import subprocess
import sys
from pathlib import Path


def test_bench_refuses_cpu(tmp_path):
    repo = Path(__file__).parent.parent
    out = subprocess.run(
        [sys.executable, str(repo / "bench.py")],
        capture_output=True,
        text=True,
        timeout=300,
        env={
            "PATH": "/usr/bin:/bin:/usr/local/bin",
            "JAX_PLATFORMS": "cpu",
            "HOME": str(tmp_path),
        },
        cwd=repo,
    )
    assert out.returncode != 0
    assert not [l for l in out.stdout.splitlines() if l.startswith("{")]
    assert "GPU" in out.stderr
