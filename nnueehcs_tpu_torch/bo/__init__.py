"""Bayesian-optimization engine with an Ax-compatible client API
(counterpart of ``nnueehcs_tpu/bo``)."""
from .client import AxClient, BOClient, ObjectiveProperties
from .space import ParameterSpace
from .gp import GaussianProcess

__all__ = ['AxClient', 'BOClient', 'ObjectiveProperties', 'ParameterSpace',
           'GaussianProcess']
