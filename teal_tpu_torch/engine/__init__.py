from teal_tpu_torch.engine.generate import GenerateStats, Generator
from teal_tpu_torch.engine.serving import ContinuousBatchingEngine, Request

__all__ = ["ContinuousBatchingEngine", "Generator", "GenerateStats",
           "Request"]
