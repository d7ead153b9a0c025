from teal_tpu_torch.models import llama

__all__ = ["llama"]
