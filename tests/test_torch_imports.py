"""The port stands alone: importing every repro_torch module loads neither
JAX nor the JAX package, and its entry points want the card by default."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

SRC = Path(__file__).resolve().parents[1] / "src"

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
"""


def test_import_every_module_without_jax_or_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.split(" ", 1)
    assert int(n) >= 82            # every module of the package was imported
    assert bad.strip() == "[]", bad


def test_model_wants_the_card_by_default():
    from repro_torch.configs import get_config
    from repro_torch.models.model import Model
    cfg = get_config("smollm-135m", reduced=True)
    if torch.cuda.is_available():
        assert Model(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Model(cfg)
    assert Model(cfg, device="cpu").device.type == "cpu"


_IMPORT_SCRIPTS = r"""
import importlib.util, sys
for path in sys.argv[1:]:
    spec = importlib.util.spec_from_file_location("m", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
print(sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro")))
"""


def test_chip_scripts_import_neither_jax_nor_repro():
    """``chip_smoke.py`` and the port's chip scripts run where there is no
    JAX: importing them loads neither JAX nor the JAX package."""
    root = SRC.parent
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run(
        [sys.executable, "-c", _IMPORT_SCRIPTS, str(root / "chip_smoke.py"),
         str(root / "scripts" / "serve_decode_host.py")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
