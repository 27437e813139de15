from repro_torch.data.pipeline import SyntheticImages, SyntheticLM

__all__ = ["SyntheticLM", "SyntheticImages"]
