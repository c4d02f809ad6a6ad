from repro_torch.models.model import (Model, apply_model, compute_dtype,
                                      init_cache, init_model)

__all__ = ["Model", "apply_model", "compute_dtype", "init_cache",
           "init_model"]
