"""Fine-tuning step of the port, on one device
(counterpart of ``metagenomic_deepfri_tpu.parallel``; no mesh yet)."""
