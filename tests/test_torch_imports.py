"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points run on the CUDA card unless asked for the CPU."""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    mods = []
    for path in PORT.rglob("*.py"):
        parts = path.relative_to(PORT.parent).with_suffix("").parts
        mods.append(".".join(parts[:-1] if parts[-1] == "__init__"
                             else parts))
    return sorted(mods)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    mods = _port_modules()
    assert "repro_torch.core.client" in mods
    assert "repro_torch.kernels.rs_parity.kernel" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax'\n"
            "             or m.startswith(('jax.', 'jaxlib'))\n"
            "             or m == 'repro' or m.startswith('repro.'))\n"
            "print('LEAKED', bad)\n")
    res = subprocess.run([sys.executable, "-c", code], env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "LEAKED []" in res.stdout, res.stdout


def test_sources_name_neither_jax_nor_repro():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = {str(f.relative_to(ROOT)): m.group(0).strip()
            for f in files for m in [pat.search(f.read_text())] if m}
    assert not hits, hits
    # the pattern does catch what it is meant to
    assert pat.search("from repro.core import sim\n")
    assert pat.search("import jax.numpy as jnp\n")
    assert pat.search("    import jax\n")
    assert not pat.search("from repro_torch.core import sim\n")
    assert not pat.search("import repro_torch.core\n")


def test_client_defaults_to_the_card_and_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from repro_torch.core import ROS2Client
    from repro_torch.core.object_store import MediaScrubber, StorageCluster
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ROS2Client()
    with pytest.raises(RuntimeError, match="CUDA"):
        ROS2Client(mode="dpu", ec=None, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        StorageCluster(n_targets=2)
    cluster = StorageCluster(n_targets=2, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            MediaScrubber(cluster)
    finally:
        cluster.close()


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], env=env,
                         capture_output=True, text=True, timeout=120,
                         cwd=tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
