from .jax2torch import params_to_state_dict

__all__ = ['params_to_state_dict']
