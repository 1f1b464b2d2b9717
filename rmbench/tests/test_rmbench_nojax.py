"""Nothing the benchmark runs imports JAX or the JAX package: every module
under rmbench/ by its imports, and what a run loads, by the top-level
names in ``sys.modules`` (the part before the first dot, compared whole:
the port's name begins with the JAX package's). The reference imports
nothing of the port either."""

import ast
import json
import subprocess
import sys

import pytest
import _tiny

from rmbench import run as rmrun

BANNED = {"jax", "jaxlib", "flax", "tbraymarcherplugin_tpu"}
PORT = "tbraymarcherplugin_tpu_torch"
HERE = _tiny.ROOT / "rmbench"
SOURCES = sorted(HERE.rglob("*.py"))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_module_imports(path):
    names = set(_imports(path))
    assert not names & BANNED
    if "reference" in path.relative_to(HERE).parts:
        assert PORT not in names


def test_banned_names_compare_whole():
    mods = {"tbraymarcherplugin_tpu_torch", "tbraymarcherplugin_tpu_torch.ops",
            "jaxtyping", "numpy", "jax.numpy", "jaxlib", "flax.linen",
            "tbraymarcherplugin_tpu.ops"}
    assert rmrun.banned_modules(mods) == sorted(
        {"jax.numpy", "jaxlib", "flax.linen", "tbraymarcherplugin_tpu.ops"})


def test_a_run_loads_no_jax():
    code = (
        "import sys, json, time\n"
        "sys.path.insert(0, 'rmbench/tests')\n"
        "import _tiny\n"
        "from rmbench import run, calibrate\n"
        "for name in ('ct256_bone.orbit', 'ct256_bone.fit'):\n"
        "    _tiny.run(_tiny.cell(name, trace_iters=2), seconds=0.1,"
        " traced=name.endswith('fit'))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=_tiny.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert PORT in loaded
    assert not loaded & BANNED
