"""Model zoo: the networks the port carries so far, built on its symbol
API exactly as the JAX package builds them."""
from .mlp import get_mlp
from .vgg import get_vgg

__all__ = ["get_mlp", "get_vgg"]
