# The AR-RFF flagship (config #4) with the COCO detection data settings:
# the leaf config has no data section. Paths are relative to this file.
_base_ = [
    '../../configs/arfe/faster_rcnn_r50_arfpn_arrff_1x_coco.py',
    '../../configs/_base_/datasets/coco_detection.py',
]
