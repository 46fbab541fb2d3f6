from .pipeline import DataConfig, Prefetcher, SyntheticLMStream, to_device

__all__ = ["DataConfig", "Prefetcher", "SyntheticLMStream", "to_device"]
