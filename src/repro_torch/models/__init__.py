from repro_torch.models.model import (Model, MTPHead, PaperNet, apply_model,
                                      apply_paper_net, check_slab_ported,
                                      check_train_ported, compute_dtype,
                                      init_cache, init_model, init_paper_net,
                                      mtp_draft)

__all__ = ["Model", "MTPHead", "PaperNet", "apply_model", "apply_paper_net",
           "check_slab_ported", "check_train_ported", "compute_dtype",
           "init_cache", "init_model", "init_paper_net", "mtp_draft"]
