from repro_torch.serve.engine import (ServeEngine, make_decode_step,
                                     make_engine, make_engine_from_checkpoint,
                                     make_prefill_step)
from repro_torch.serve.frontdoor import FrontDoor, StreamHandle
from repro_torch.serve.kvcache import PagedKVCache, PagedView
from repro_torch.serve.prefix import PrefixCache
from repro_torch.serve.sampling import (SamplingConfig, accept_speculative,
                                        filter_logits, masked_sample, sample)
from repro_torch.serve.scheduler import ContinuousScheduler, ServeRequest

__all__ = ["ServeEngine", "make_decode_step", "make_engine",
           "make_engine_from_checkpoint", "make_prefill_step",
           "FrontDoor", "StreamHandle", "PagedKVCache", "PagedView",
           "PrefixCache", "SamplingConfig", "accept_speculative",
           "filter_logits", "masked_sample", "sample",
           "ContinuousScheduler", "ServeRequest"]
