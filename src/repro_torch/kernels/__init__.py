"""Hand-written CUDA kernels of the port, each beside its plain version.

``flash_attention``, ``wkv6`` and ``mamba_scan`` here are ``ops``'s, with
the implementation dispatch (``impl=``, ``set_default_impl``) and the
flash block surface (``set_flash_blocks``), under the reference's names
(``repro.kernels``); the kernel modules' own wrappers are
``kernels.<module>.<name>``."""
from repro_torch.kernels.build import launch_counts, reset_launch_counts
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.mamba_scan import (mamba_chunked, mamba_chunked_bwd,
                                            mamba_ref)
from repro_torch.kernels.paged_decode import (paged_flash_decode,
                                              paged_flash_decode_mla,
                                              paged_flash_decode_mla_ref,
                                              paged_flash_decode_ref)
from repro_torch.kernels.wkv6 import wkv6_chunked, wkv6_chunked_bwd, wkv6_ref
from repro_torch.kernels import ops
from repro_torch.kernels.ops import (flash_attention, get_default_impl,
                                     get_flash_blocks, mamba_scan, mamba_step,
                                     set_default_impl, set_flash_blocks, wkv6,
                                     wkv6_step)

__all__ = ["ops", "flash_attention", "flash_attention_ref", "mamba_chunked",
           "mamba_chunked_bwd", "mamba_ref", "mamba_scan", "mamba_step",
           "paged_flash_decode", "paged_flash_decode_mla",
           "paged_flash_decode_mla_ref", "paged_flash_decode_ref", "wkv6",
           "wkv6_chunked", "wkv6_chunked_bwd", "wkv6_ref", "wkv6_step",
           "set_default_impl", "get_default_impl", "set_flash_blocks",
           "get_flash_blocks", "launch_counts", "reset_launch_counts"]
