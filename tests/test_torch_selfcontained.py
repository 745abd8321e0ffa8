"""The port stands on its own files.

A copy of ``metagenomic_deepfri_tpu_torch/`` alone (no JAX package beside
it, no ``build/``) finds its native C++ sources and its FoldComp
blocklist; the copies it carries are byte-equal to the JAX package's, so
both packages run one NW and filter one ID set; and no string constant in
the port or in ``chip_smoke.py`` names the JAX package's directory as a
path component.
"""

import ast
import gzip
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "metagenomic_deepfri_tpu_torch"
JAX_PKG = REPO / "metagenomic_deepfri_tpu"
SHARED_FILES = ("native/nw.cpp", "native/kmersearch.cpp",
                "assets/highquality_clust30_error_ids.txt.gz")
# "file:line" citations of the TPU kernel a port's kernel replaces (the
# ``replaces`` key of chip_smoke.py's kernel table) are labels, not paths
# that are opened.
CITATION = re.compile(r"^[\w./-]+\.py:\d+(-\d+)?$")


def test_copy_of_the_port_alone_finds_its_files(tmp_path):
    shutil.copytree(PORT, tmp_path / PORT.name,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "MDEEPFRI_BLOCKLIST")}
    proc = subprocess.run(
        [sys.executable, "-I", "-c", textwrap.dedent(f"""
            import importlib.util, sys
            sys.path.insert(0, {str(tmp_path)!r})
            assert importlib.util.find_spec("metagenomic_deepfri_tpu") \\
                is None, "the JAX package is importable"
            from metagenomic_deepfri_tpu_torch.native import build
            from metagenomic_deepfri_tpu_torch.pipeline import (
                ASSETS_DIR, _load_blocklist)
            for name in build.NAMES:
                path = build.source_path(name)
                assert path.is_file(), path
                assert path.is_relative_to({str(tmp_path)!r}), path
                print("SOURCE", name, path.stat().st_size)
            assert ASSETS_DIR.is_relative_to({str(tmp_path)!r}), ASSETS_DIR
            ids = _load_blocklist("highquality_clust30")
            print("BLOCKLIST", len(ids))
            print("\\n".join(sorted(ids)))
        """)], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    sizes = {ln.split()[1]: int(ln.split()[2]) for ln in lines
             if ln.startswith("SOURCE")}
    assert set(sizes) == {"nw", "kmersearch", "tsvfmt"}
    assert {n: sizes[n] for n in ("nw", "kmersearch")} == {
        n: (JAX_PKG / "native" / f"{n}.cpp").stat().st_size
        for n in ("nw", "kmersearch")}
    i = next(i for i, ln in enumerate(lines) if ln.startswith("BLOCKLIST"))
    assert lines[i] == "BLOCKLIST 27675"
    with gzip.open(JAX_PKG / SHARED_FILES[2], "rt", encoding="utf-8") as f:
        want = {ln.strip() for ln in f if ln.strip()}
    assert set(lines[i + 1:]) == want and len(want) == 27675


def test_shared_files_equal_the_jax_packages():
    for rel in SHARED_FILES:
        assert (PORT / rel).read_bytes() == (JAX_PKG / rel).read_bytes(), rel


def _docstrings(tree) -> set:
    ids = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body:
            first = node.body[0]
            if isinstance(first, ast.Expr) and isinstance(
                    first.value, ast.Constant):
                ids.add(id(first.value))
    return ids


def test_no_string_names_the_jax_package_directory():
    """No string constant (docstrings apart) of the port or
    ``chip_smoke.py`` has ``metagenomic_deepfri_tpu`` as a path component,
    so neither can build a path into the JAX package's tree."""
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 50
    found = []
    for path in files:
        tree = ast.parse(path.read_text(encoding="utf-8"))
        skip = _docstrings(tree)
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Constant)
                    and isinstance(node.value, str)) or id(node) in skip:
                continue
            parts = re.split(r"[/\\]", node.value)
            if JAX_PKG.name in parts and not CITATION.match(node.value):
                found.append(f"{path.relative_to(REPO)}:{node.lineno}: "
                             f"{node.value!r}")
    assert not found, found
