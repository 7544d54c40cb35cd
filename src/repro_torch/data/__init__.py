from repro_torch.data.pipeline import Batch, SyntheticTokens

__all__ = ["SyntheticTokens", "Batch"]
