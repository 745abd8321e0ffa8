"""DeepFRI GCN and its LSTM language-model branch in PyTorch
(counterpart of ``metagenomic_deepfri_tpu.models``)."""
