from hbird_tpu_torch.bank.io import load_memory, save_memory

__all__ = ["save_memory", "load_memory"]
