"""PyTorch/CUDA port of metagenomic-deepfri-tpu for NVIDIA Hopper GPUs.

The JAX package :mod:`metagenomic_deepfri_tpu` stays the reference; this
package mirrors its layout (``ops/``, ``models/``, ``batching/``) so every
counterpart is easy to find, and imports ``torch`` and numpy only — never
``jax`` nor any module of the JAX package.

The fused-coordinates GCN path (projected CA coordinates → batched engine →
GCN forward → per-term scores) runs through two hand-written CUDA kernels in
``csrc/graphconv.cu`` (adjacency degrees and aggregation, the counterparts of
the JAX package's Pallas kernels in ``ops/graphconv_pallas.py``). They are
compiled with ``nvcc`` on first use (:mod:`.ops._build`); importing this
package builds nothing.

Every public function takes an explicit ``device`` (or tensors already on
one); nothing here picks the CPU when a GPU is missing.
"""

import os

__version__ = "0.1.0"

# Ontology / prediction mode registry and the published weights' links:
# copies of ``metagenomic_deepfri_tpu/__init__.py`` (reference
# ``mDeepFRI/__init__.py:47-80``).
DEEPFRI_MODES = {
    "bp": "GO Biological Process",
    "cc": "GO Cellular Component",
    "mf": "GO Molecular Function",
    "ec": "Enzyme Commission",
}

WEIGHTS_REPO_URL = "https://huggingface.co/valentynbez/mDeepFRI/resolve/main/"


def make_links(repo_url: str, prefix: str, terms) -> dict:
    """Per-mode weight/config URL dict (reference
    ``mDeepFRI/__init__.py:57-65``)."""
    return {
        term: {
            "model": os.path.join(repo_url, f"{prefix}_{term}.onnx"),
            "config": os.path.join(repo_url,
                                   f"{prefix}_{term}_model_params.json"),
        }
        for term in terms
    }


cnn_model_links = make_links(WEIGHTS_REPO_URL, "DeepCNN-MERGED",
                             DEEPFRI_MODES.keys())

# v1.0 GCN covers all four modes; v1.1 drops EC.
gcn_model_links = {
    "1.0": make_links(
        WEIGHTS_REPO_URL,
        "DeepFRI-MERGED_GraphConv_gcd_512-512-512_fcd_1024_ca_10.0",
        DEEPFRI_MODES.keys(),
    ),
    "1.1": make_links(
        WEIGHTS_REPO_URL,
        "DeepFRI-UNIPROT_GraphConv_gcd_512-512-512_fcd_1024_ca_10.0_ext_desc",
        ["bp", "cc", "mf"],
    ),
}
