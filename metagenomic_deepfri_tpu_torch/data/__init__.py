"""Host-side data ingestion of the port: protein structure files
(counterpart of ``metagenomic_deepfri_tpu.data``)."""
