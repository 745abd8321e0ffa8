"""General utilities of the port: subprocesses, downloads, model configuration.

Jax-free copies of ``metagenomic_deepfri_tpu/utils.py``: ``run_command``
(``:27``), ``download_file`` (``:81``), ``download_model_weights`` (``:95``),
``generate_config_json`` (``:116``), ``load_deepfri_config`` (``:154``),
``remove_intermediate_files`` (``:181``), ``opener`` and ``get_json_values``
(``:188-204``). A failed download raises :class:`DownloadError`, a
``RuntimeError`` as in the JAX package, which the command line reports
without a traceback.
"""

from __future__ import annotations

import gzip
import json
import re
import shutil
import subprocess
import sys
from glob import glob
from pathlib import Path
from typing import Iterable, List, Literal


class DownloadError(RuntimeError):
    """An HTTP(S) download failed (no network, bad URL, server error)."""


def run_command(command: str, echo: bool = True) -> str:
    """Run a shell command, streaming combined stdout/stderr line-by-line
    as it is produced (external tools like mmseqs print progress), and
    return the full captured output. Raises RuntimeError on non-zero exit
    (same contract as reference ``utils.py:40-91``)."""
    captured: List[str] = []
    with subprocess.Popen(command, shell=True, text=True,
                          stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT) as process:
        assert process.stdout is not None
        for line in process.stdout:
            captured.append(line)
            if echo:
                sys.stdout.write(line)
    if process.returncode != 0:
        raise RuntimeError(
            f"Command {command} failed with exit code {process.returncode}")
    return "".join(captured)


def download_file(url: str, path) -> None:
    """HTTP(S) download via urllib (no ``requests`` dependency)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url,
                                 headers={"User-Agent": "mdeepfri-tpu"})
    try:
        with urllib.request.urlopen(req) as resp, open(path, "wb") as f:
            shutil.copyfileobj(resp, f)
    except urllib.error.URLError as err:
        raise DownloadError(f"Download of {url} failed: {err}") from err


def download_model_weights(output_filepath,
                           version: Literal["1.0", "1.1"] = "1.1") -> None:
    """Fetch the published ONNX weights + param JSONs from Hugging Face
    (reference ``utils.py:119-151``)."""
    from metagenomic_deepfri_tpu_torch import (cnn_model_links,
                                               gcn_model_links)

    output_path = Path(output_filepath)
    if output_path.exists():
        shutil.rmtree(output_path)
    output_path.mkdir(parents=True)

    for mode in gcn_model_links[version]:
        for url in gcn_model_links[version][mode].values():
            download_file(url, output_path / url.split("/")[-1])
    for mode in cnn_model_links:
        if version == "1.1" and mode == "ec":
            continue
        for url in cnn_model_links[mode].values():
            download_file(url, output_path / url.split("/")[-1])


def generate_config_json(weights_filepath,
                         version: Literal["1.0", "1.1"]) -> None:
    """Scan a weights folder and write model_config.json (reference
    ``utils.py:154-212``: mode matched by regex on filename, CNN vs GCN by
    'CNN'/'GraphConv' substrings; missing models raise)."""
    weights_path = Path(weights_filepath)
    config = {
        "gcn": {"bp": None, "cc": None, "mf": None, "ec": None},
        "cnn": {"bp": None, "cc": None, "mf": None, "ec": None},
        "version": None,
    }
    models = list(weights_path.glob("*.onnx"))
    possible_modes = "|".join(config["cnn"].keys())
    for model in models:
        match = re.search(possible_modes, model.name)
        if not match:
            continue
        mode = match.group(0)
        if "CNN" in model.name:
            config["cnn"][mode] = str(model)
        elif "GraphConv" in model.name:
            config["gcn"][mode] = str(model)
    config["version"] = version
    if version == "1.1":
        del config["cnn"]["ec"]
        del config["gcn"]["ec"]

    for net in ("cnn", "gcn"):
        for mode, path in config[net].items():
            if path is None:
                raise ValueError(
                    f"Model weights for {net} {mode} not found in "
                    f"{weights_path}")
    with open(weights_path / "model_config.json", "w",
              encoding="utf-8") as f:
        json.dump(config, f, indent=4, sort_keys=True)


def load_deepfri_config(weights) -> dict:
    """Validate a weights folder and absolutise model paths (reference
    ``utils.py:242-276``)."""
    weights = Path(weights)
    assert weights.exists(), f"DeepFRI weights not found at {weights}"
    assert weights.is_dir(), \
        "DeepFRI weights should be a directory, not a file."
    config_path = weights / "model_config.json"
    assert config_path.exists(), \
        "DeepFRI weights are missing model_config.json"
    with open(config_path, "r", encoding="utf-8") as f:
        models_config = json.load(f)
    for net in ("cnn", "gcn"):
        for model_type, model_path in models_config[net].items():
            model_name = weights / Path(model_path).name
            config_name = weights / (Path(model_path).stem
                                     + "_model_params.json")
            assert model_name.exists(), \
                f"DeepFRI weights are missing {model_type} model " \
                f"at {model_name}"
            assert config_name.exists(), \
                f"DeepFRI weights are missing {model_type} model config " \
                f"at {config_name}"
            models_config[net][model_type] = str(model_name.absolute())
    return models_config


def remove_intermediate_files(temporary_files: Iterable) -> None:
    """Remove files matching each prefix glob (reference ``utils.py:225-239``)."""
    for file in temporary_files:
        for ext in glob(str(file) + "*"):
            Path(ext).unlink()


def opener(filepath, mode: str = "rt"):
    """gzip-aware JSON loader (reference ``utils.py:348-368``)."""
    with open(filepath, "rb") as f:
        sig = f.read(2)
    if sig == b"\x1f\x8b":
        with gzip.open(filepath, mode, encoding="utf-8") as json_file:
            return json.load(json_file)
    with open(filepath, mode, encoding="utf-8") as json_file:
        return json.load(json_file)


def get_json_values(config_json, key: str) -> List[str]:
    """Pull a key (``goterms``/``gonames``) from a model params JSON
    (reference ``utils.py:371-389``)."""
    config_json = Path(config_json)
    assert config_json.exists(), f"Config json not found at {config_json}"
    return opener(str(config_json))[key]
