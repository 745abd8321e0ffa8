"""DeepFRI GCN and its language-model branch (the LSTM-LM, or ESM-2 in
its place) in PyTorch (counterpart of ``metagenomic_deepfri_tpu.models``)."""
