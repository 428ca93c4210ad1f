from .additional import (get_adaptive_scale_rois, get_boundary_rois,
                         get_context_rois, get_large_small_rois,
                         get_large_wh_rois, get_small_wh_rois)

__all__ = ['get_adaptive_scale_rois', 'get_boundary_rois', 'get_context_rois',
           'get_large_small_rois', 'get_large_wh_rois', 'get_small_wh_rois']
