"""Model-configuration helpers of the port.

Jax-free copies of ``load_deepfri_config``, ``opener`` and
``get_json_values`` from ``metagenomic_deepfri_tpu/utils.py:154-203``
(reference ``utils.py:242-276`` and ``:348-389``).
"""

from __future__ import annotations

import gzip
import json
from pathlib import Path
from typing import List


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
