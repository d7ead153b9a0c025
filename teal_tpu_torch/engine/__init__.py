from teal_tpu_torch.engine.generate import GenerateStats, Generator

__all__ = ["Generator", "GenerateStats"]
