"""Gene Ontology handling of the port: OBO parsing and true-path
propagation (counterpart of ``metagenomic_deepfri_tpu.ontology``)."""
