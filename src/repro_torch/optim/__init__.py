from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.compress import compress_decompress, compress_init
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["adamw_init", "adamw_update", "warmup_cosine",
           "compress_init", "compress_decompress"]
