from repro_torch.tune.variants import KernelVariant, default_variant

__all__ = ["KernelVariant", "default_variant"]
