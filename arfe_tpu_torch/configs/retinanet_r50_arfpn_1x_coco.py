# RetinaNet R50 + AR-FPN (config #2) with the COCO detection data settings:
# the leaf config has no data section. Paths are relative to this file.
_base_ = [
    '../../configs/arfe/retinanet_r50_arfpn_1x_coco.py',
    '../../configs/_base_/datasets/coco_detection.py',
]
