"""Entry points that measure the card fail without it (no CPU number under
a device metric), and the layout default follows its precedence."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_fails_without_a_gpu(capsys):
    sys.path.insert(0, ROOT)
    import bench
    with pytest.raises(SystemExit) as e:
        bench.main()
    assert e.value.code != 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert "error" in rec and "value" not in rec
    assert rec["device"]["platform"] == "cpu"


def test_chip_smoke_prints_no_result_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("explicit,env,use_pallas,want", [
    (True, None, False, True),      # explicit wins
    (False, "1", True, False),      # explicit wins over the env
    (None, "0", True, False),       # env forces off
    (None, "1", False, True),       # env forces on
    (None, None, False, False),     # scan packer: block concat
])
def test_resolve_segmented_precedence(monkeypatch, explicit, env,
                                      use_pallas, want):
    from flutpu.codec.jpeg import resolve_segmented
    if env is None:
        monkeypatch.delenv("FLUTPU_SEGMENTED", raising=False)
    else:
        monkeypatch.setenv("FLUTPU_SEGMENTED", env)
    assert resolve_segmented(explicit, use_pallas) is want
