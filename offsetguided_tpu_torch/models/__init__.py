from .checkpoint import state_dict_from_jax
from .network import PoseNet, count_params, random_posenet

__all__ = ['PoseNet', 'count_params', 'random_posenet', 'state_dict_from_jax']
