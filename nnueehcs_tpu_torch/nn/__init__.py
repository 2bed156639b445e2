"""Network layers and the architecture-list builder."""
from .layers import LAYER_REGISTRY
from .network import Network, LayerBuilder, build_network

__all__ = ['LAYER_REGISTRY', 'Network', 'LayerBuilder', 'build_network']
