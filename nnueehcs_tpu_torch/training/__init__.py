"""Checkpoint bundles (the trainer is not ported yet)."""
from .checkpoint import FORMAT, build_from_bundle, load_model, save_model

__all__ = ['FORMAT', 'build_from_bundle', 'load_model', 'save_model']
