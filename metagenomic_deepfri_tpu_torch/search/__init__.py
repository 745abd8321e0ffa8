"""Homology search of the port: query files, result tables, databases,
coordinate extraction, the built-in k-mer engine and the MMseqs2 dispatch
(counterpart of ``metagenomic_deepfri_tpu.search``)."""
