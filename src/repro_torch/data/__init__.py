from repro_torch.data.pipeline import (DataConfig, Prefetcher,
                                      SyntheticLMData, to_device)

__all__ = ["DataConfig", "SyntheticLMData", "Prefetcher", "to_device"]
