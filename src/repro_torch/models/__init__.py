from repro_torch.models.model import (Model, MTPHead, PaperNet, apply_model,
                                      apply_paper_net, batch_inputs,
                                      check_paged_ported, check_slab_ported,
                                      check_token_serving,
                                      check_train_ported, compute_dtype,
                                      encoder_cfg, init_cache, init_model,
                                      init_paper_net, mtp_draft)

__all__ = ["Model", "MTPHead", "PaperNet", "apply_model", "apply_paper_net",
           "batch_inputs", "check_paged_ported", "check_slab_ported",
           "check_token_serving", "check_train_ported", "compute_dtype",
           "encoder_cfg",
           "init_cache", "init_model", "init_paper_net", "mtp_draft"]
