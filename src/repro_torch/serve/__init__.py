from repro_torch.serve.engine import (ServeEngine, make_decode_step,
                                     make_engine, make_prefill_step)
from repro_torch.serve.kvcache import PagedKVCache, PagedView
from repro_torch.serve.sampling import (SamplingConfig, filter_logits,
                                        masked_sample, sample)
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

__all__ = ["ServeEngine", "make_decode_step", "make_engine",
           "make_prefill_step", "PagedKVCache", "PagedView", "SamplingConfig",
           "filter_logits", "masked_sample", "sample",
           "ContinuousScheduler", "ServeRequest"]
