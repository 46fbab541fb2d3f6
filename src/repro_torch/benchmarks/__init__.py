"""Benchmarks of the port, runnable as modules
(``python -m repro_torch.benchmarks.<name>``)."""
