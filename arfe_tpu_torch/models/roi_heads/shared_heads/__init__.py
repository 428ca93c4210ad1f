from .res_layer import ResLayer

__all__ = ['ResLayer']
