# Mask R-CNN R50 + AR-FPN (config #5a) with the COCO instance data settings
# (masks in the train pipeline, bbox and segm evaluation): the leaf config
# has no data section. Paths are relative to this file.
_base_ = [
    '../../configs/arfe/mask_rcnn_r50_arfpn_1x_coco.py',
    '../../configs/_base_/datasets/coco_instance.py',
]
