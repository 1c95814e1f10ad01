"""Weight bridges into the port: flax variables of the JAX package
(``from_flax``) and reference PyTorch checkpoints (``torch_converter``)."""
from .torch_converter import convert_torch_state_dict, load_torch_checkpoint

__all__ = ["convert_torch_state_dict", "load_torch_checkpoint"]
