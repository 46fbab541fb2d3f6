"""PyTorch/CUDA port of the HyPar reproduction on one NVIDIA H100: paged
serving of dense GQA and Mamba-2 decoders, and the paper's job-model
runtime with its Jacobi solver."""
