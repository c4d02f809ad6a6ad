from repro_torch.models.model import (Model, apply_model, check_slab_ported,
                                      check_train_ported, compute_dtype,
                                      init_cache, init_model)

__all__ = ["Model", "apply_model", "check_slab_ported", "check_train_ported",
           "compute_dtype", "init_cache", "init_model"]
