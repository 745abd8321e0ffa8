"""Per-architecture download of the external search/structure engines.

A copy of ``metagenomic_deepfri_tpu/search/binaries.py`` without the
wheel-vendored directory (the port vendors no binaries).

The reference vendors ``mmseqs`` and ``foldcomp`` into the wheel at build
time (reference ``setup.py:66-135``: archspec CPU sniffing → per-arch
tarball from mmseqs.com). We install nothing at build time — the package
works without either binary (built-in k-mer search; FASTA / PDB-directory
databases) — but a FoldComp ``.fcz`` database or a large-scale MMseqs2
search wants the real engines. ``mdeepfri get-binaries`` fetches the same
per-arch builds the reference uses into a user-writable tools directory
that binary discovery (:func:`..mmseqs.mmseqs_path` /
:func:`..mmseqs.foldcomp_path`) checks after the environment override and
before PATH.
"""

from __future__ import annotations

import logging
import os
import platform
import stat
import tarfile
from pathlib import Path
from typing import Iterable, Optional

logger = logging.getLogger(__name__)

# Public release tarballs — the same URL tables the reference resolves
# (reference ``setup.py:64-78``).
FOLDCOMP_BINARIES = {
    "linux": "https://mmseqs.com/foldcomp/foldcomp-linux-x86_64.tar.gz",
    "aarch64": "https://mmseqs.com/foldcomp/foldcomp-linux-arm64.tar.gz",
    "macos": "https://mmseqs.com/foldcomp/foldcomp-macos-universal.tar.gz",
}
MMSEQS_BINARIES = {
    "avx2": "https://mmseqs.com/latest/mmseqs-linux-avx2.tar.gz",
    "sse41": "https://mmseqs.com/latest/mmseqs-linux-sse41.tar.gz",
    "sse2": "https://mmseqs.com/latest/mmseqs-linux-sse2.tar.gz",
    "aarch64": "https://mmseqs.com/latest/mmseqs-linux-arm64.tar.gz",
    "ppc": "https://mmseqs.com/latest/mmseqs-linux-ppc64le-power8.tar.gz",
    "macos": "https://mmseqs.com/latest/mmseqs-osx-universal.tar.gz",
}


def tools_dir() -> Path:
    """Where fetched binaries live (override: ``MDEEPFRI_TOOLS_DIR``)."""
    env = os.environ.get("MDEEPFRI_TOOLS_DIR")
    if env:
        return Path(env)
    return Path.home() / ".local" / "share" / "mdeepfri" / "bin"


def _cpu_flags() -> set:
    """x86 feature flags from /proc/cpuinfo (no archspec dependency —
    the reference pulls in archspec just for this, ``setup.py:52-62``)."""
    try:
        with open("/proc/cpuinfo", "r", encoding="utf-8") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    return set(line.split(":", 1)[1].split())
    except OSError:
        pass
    return set()


def select_mmseqs_url(machine: Optional[str] = None,
                      system: Optional[str] = None,
                      flags: Optional[set] = None) -> str:
    """The mmseqs build for this host (reference ``setup.py:115-127``)."""
    machine = machine or platform.machine()
    system = system or platform.system()
    if system == "Darwin":
        return MMSEQS_BINARIES["macos"]
    if machine in ("aarch64", "arm64"):
        return MMSEQS_BINARIES["aarch64"]
    if machine.startswith("ppc64"):
        return MMSEQS_BINARIES["ppc"]
    flags = _cpu_flags() if flags is None else flags
    if "avx2" in flags:
        return MMSEQS_BINARIES["avx2"]
    if "sse4_1" in flags:
        return MMSEQS_BINARIES["sse41"]
    return MMSEQS_BINARIES["sse2"]


def select_foldcomp_url(machine: Optional[str] = None,
                        system: Optional[str] = None) -> str:
    """The foldcomp build for this host (reference ``setup.py:90-99``)."""
    machine = machine or platform.machine()
    system = system or platform.system()
    if system == "Darwin":
        return FOLDCOMP_BINARIES["macos"]
    if machine in ("aarch64", "arm64"):
        return FOLDCOMP_BINARIES["aarch64"]
    return FOLDCOMP_BINARIES["linux"]


def _extract_binary(tar_path: Path, wanted: str, dest: Path) -> Path:
    """Pull the first member named ``wanted`` out of a tarball into dest."""
    with tarfile.open(tar_path, "r:gz") as archive:
        member = next((m for m in archive.getmembers()
                       if m.isfile() and Path(m.name).name == wanted), None)
        if member is None:
            raise RuntimeError(
                f"{tar_path.name} does not contain a '{wanted}' binary")
        src = archive.extractfile(member)
        assert src is not None
        out = dest / wanted
        with open(out, "wb") as f:
            f.write(src.read())
    out.chmod(out.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP
              | stat.S_IXOTH)
    return out


def fetch_binaries(output_dir=None,
                   tools: Iterable[str] = ("mmseqs", "foldcomp")) -> dict:
    """Download + install the requested engine binaries; {tool: path}.

    Raises RuntimeError with the failing URL when the host has no network
    egress — the error is actionable (run it again on a connected machine,
    or install the tools on PATH / set MDEEPFRI_*_PATH).
    """
    from metagenomic_deepfri_tpu_torch.utils import download_file

    dest = Path(output_dir) if output_dir else tools_dir()
    dest.mkdir(parents=True, exist_ok=True)
    urls = {"mmseqs": select_mmseqs_url, "foldcomp": select_foldcomp_url}
    installed = {}
    for tool in tools:
        if tool not in urls:
            raise ValueError(f"unknown tool {tool!r} "
                             f"(expected one of {sorted(urls)})")
        url = urls[tool]()
        tar_path = dest / f"{tool}.tar.gz"
        logger.info("Downloading %s from %s", tool, url)
        download_file(url, tar_path)
        try:
            installed[tool] = str(_extract_binary(tar_path, tool, dest))
        finally:
            tar_path.unlink(missing_ok=True)
        logger.info("Installed %s -> %s", tool, installed[tool])
    return installed


def tool_install_hint(tool: str) -> str:
    """One-line remediation string used by gated call sites."""
    return (f"run `mdeepfri get-binaries` to download it (internet "
            f"required), install `{tool}` on PATH, or point "
            f"MDEEPFRI_{tool.upper()}_PATH at an existing binary")
