"""Length bucketing and the batched inference engine of the port
(counterpart of ``metagenomic_deepfri_tpu.batching``)."""
