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

__version__ = "0.1.0"
