from repro_torch.data.synthetic import synthetic_tokens

__all__ = ["synthetic_tokens"]
