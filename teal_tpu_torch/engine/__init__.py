from teal_tpu_torch.engine.generate import GenerateStats, Generator
from teal_tpu_torch.engine.serving import ContinuousBatchingEngine, Request
from teal_tpu_torch.engine.speculative import speculative_generate

__all__ = ["ContinuousBatchingEngine", "Generator", "GenerateStats",
           "Request", "speculative_generate"]
