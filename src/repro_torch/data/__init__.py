from repro_torch.data.synthetic import make_batch, synthetic_tokens

__all__ = ["make_batch", "synthetic_tokens"]
