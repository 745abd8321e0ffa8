"""Pairwise sequence alignment of the port: scoring matrices and the
alignment drivers over the native NW engine (counterpart of
``metagenomic_deepfri_tpu.align``)."""
