from repro_torch.serve.engine import make_engine
from repro_torch.serve.kvcache import PagedKVCache, PagedView
from repro_torch.serve.sampling import (SamplingConfig, filter_logits,
                                        masked_sample, sample)
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

__all__ = ["make_engine", "PagedKVCache", "PagedView", "SamplingConfig",
           "filter_logits", "masked_sample", "sample",
           "ContinuousScheduler", "ServeRequest"]
