"""Tensor ops of the port: one-hot, contact maps, aligned adjacency and the
GraphConv aggregation kernels (counterparts of ``metagenomic_deepfri_tpu.ops``).
"""
