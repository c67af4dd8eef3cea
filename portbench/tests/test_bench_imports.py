"""No file of the benchmark imports JAX or the JAX package, and the
yardstick (the references, the check, ESS, Philox, the work count, the
peaks, the profile reader, the metric readers) imports nothing of the
program.  Top-level module names are compared whole: rainier_tpu_torch
begins with rainier_tpu."""

import ast

from portbench.run import BASE

FORBIDDEN = {"jax", "jaxlib", "flax", "rainier_tpu"}
YARDSTICK = {"check.py", "ess.py", "philox.py", "work.py", "peaks.py",
             "profile.py", "manifest.py"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BASE.rglob("*.py"))
    assert len(files) > 10
    for path in files:
        assert not _imports(path) & FORBIDDEN, path


def test_the_yardstick_imports_nothing_of_the_program():
    for path in sorted(BASE.rglob("*.py")):
        if (path.name in YARDSTICK or path.name.endswith("_ref.py")
                or path.parent.name == "metrics"):
            assert "rainier_tpu_torch" not in _imports(path), path
