"""Deterministic synthetic data pipeline (counterpart of `repro.data`)."""
from repro_torch.data.pipeline import (DataConfig, DataIterator,
                                       host_local_batch, synth_tokens)
__all__ = ["DataConfig", "DataIterator", "host_local_batch", "synth_tokens"]
