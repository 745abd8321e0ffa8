"""Host C++ libraries of the port: the NW aligner and the k-mer prefilter,
built from the JAX package's sources with g++ at first use
(``python -m metagenomic_deepfri_tpu_torch.native.build`` builds both)."""
