"""The PyTorch port stands alone: importing it, its entry points or any of
its modules brings in neither jax nor the JAX package
(``vae_channel_dynamics_tpu``), and no source file of the port or
``chip_smoke.py`` imports either: the port must run where jax is not
installed."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "vae_channel_dynamics_tpu_torch"
ENTRY_POINTS = (PORT, f"{PORT}.serve", f"{PORT}.server", f"{PORT}.train",
                f"{PORT}.training.loop", f"{PORT}.evaluate",
                f"{PORT}.experiments.conv_bench", f"{PORT}.tools.export_model",
                f"{PORT}.tools.loader_bench")
FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|orbax|vae_channel_dynamics_tpu)(?:\.|\s|$)",
    re.MULTILINE)


def _port_modules():
    import vae_channel_dynamics_tpu_torch as port

    return [PORT] + [m.name for m in pkgutil.walk_packages(port.__path__, prefix=f"{PORT}.")]


def _imports_in_fresh_interpreter(modules):
    code = (
        "import importlib, sys\n"
        f"for name in {list(modules)!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'vae_channel_dynamics_tpu'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout.strip()


def test_entry_points_import_no_jax():
    assert _imports_in_fresh_interpreter(ENTRY_POINTS) == ""


def test_every_port_module_imports_no_jax():
    modules = _port_modules()
    assert len(modules) > 20
    assert _imports_in_fresh_interpreter(modules) == ""


@pytest.mark.parametrize("path", sorted(
    [os.path.join(root, f) for root, _dirs, files in os.walk(os.path.join(REPO, PORT))
     for f in files if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]),
    ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as f:
        found = FORBIDDEN.findall(f.read())
    assert not found, found
