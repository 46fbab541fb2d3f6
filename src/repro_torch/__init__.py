"""PyTorch/CUDA port of the serving path (paged serving of dense GQA decoders on one NVIDIA H100)."""
