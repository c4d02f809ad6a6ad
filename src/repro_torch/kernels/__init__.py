"""Hand-written CUDA kernels of the port, each beside its plain version."""
from repro_torch.kernels.build import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.mamba_scan import mamba_ref, mamba_scan, mamba_step
from repro_torch.kernels.paged_decode import (paged_flash_decode,
                                              paged_flash_decode_mla,
                                              paged_flash_decode_mla_ref,
                                              paged_flash_decode_ref)
from repro_torch.kernels.wkv6 import (wkv6, wkv6_chunked, wkv6_ref,
                                      wkv6_step)

__all__ = ["flash_attention", "flash_attention_ref", "mamba_ref",
           "mamba_scan", "mamba_step", "paged_flash_decode",
           "paged_flash_decode_mla", "paged_flash_decode_mla_ref",
           "paged_flash_decode_ref", "wkv6", "wkv6_chunked", "wkv6_ref",
           "wkv6_step", "launch_counts", "reset_launch_counts"]
