"""The port's import rule: no module of `stereovision_slam_torch` imports
JAX or the JAX package, and the port reads no file of the JAX package."""

import filecmp
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, json, pkgutil, sys
import stereovision_slam_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "stereovision_slam_tpu")))
print(json.dumps({"modules": len(names), "bad": bad}))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["modules"] > 60, res
    assert res["bad"] == [], f"the port imported {res['bad']}"


def test_place_net_weights_are_the_ports_own_copy():
    from stereovision_slam_torch.models import place_net
    port_dir = os.path.join(REPO, "stereovision_slam_torch")
    path = os.path.realpath(place_net.WEIGHTS_PATH)
    assert path.startswith(os.path.realpath(port_dir) + os.sep)
    ref = os.path.join(REPO, "stereovision_slam_tpu", "models", "weights",
                       "place_net.npz")
    assert filecmp.cmp(path, ref, shallow=False)


SCENES_AND_TRAINING = ("stereovision_slam_torch.scenes",
           "stereovision_slam_torch.apps.train_place_net",
           "stereovision_slam_torch.models.place_net")


def test_scenes_and_training_tool_import_neither_jax_nor_the_jax_package():
    """The renderers of every bench scene and PlaceNet's training tool
    (torch and numpy only: no optax, no tests.synthetic), each in a fresh
    process; the package walk above includes them."""
    probe = ("import importlib, json, sys\n"
             f"for name in {SCENES_AND_TRAINING!r}:\n"
             "    importlib.import_module(name)\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'optax', 'stereovision_slam_tpu', 'tests', "
             "'synthetic', 'benchmarks'))\n"
             "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


SCRIPTS = ("chip_smoke.py", os.path.join("tests", "torch_multicard.py"),
           os.path.join("tests", "torch_kernel_d_cards.py"))


def test_card_scripts_import_neither_jax_nor_the_jax_package():
    """`chip_smoke.py` and the card tools of SCRIPTS, each imported in a
    fresh process together with every module named by any import
    statement in it (those inside its functions too, read with `ast`)."""
    import ast

    names = []
    for script in SCRIPTS:
        tree = ast.parse(open(os.path.join(REPO, script)).read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        names.append(os.path.splitext(script)[0].replace(os.sep, "."))
    assert "tests.torch_multicard" in names and "chip_smoke" in names
    probe = ("import importlib, json, sys\n"
             f"for name in {sorted(set(names))!r}:\n"
             "    importlib.import_module(name)\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             "('jax', 'jaxlib', 'stereovision_slam_tpu'))\n"
             "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
