"""Instance masks of the port: the host containers of the data pipeline,
COCO's uncompressed run-length encoding, the training targets and the host
paste of predicted masks."""
from .mask_target import mask_target_from_crops, paste_masks_np
from .rle import (ann_to_mask, mask_iou, mask_to_rle, rle_area, rle_to_bbox,
                  rle_to_mask)
from .structures import BitmapMasks, PolygonMasks

__all__ = ['BitmapMasks', 'PolygonMasks', 'ann_to_mask', 'mask_iou',
           'mask_target_from_crops', 'mask_to_rle', 'paste_masks_np',
           'rle_area', 'rle_to_bbox', 'rle_to_mask']
