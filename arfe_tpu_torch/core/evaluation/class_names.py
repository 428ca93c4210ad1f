"""Dataset class-name tables (ref: mmdet/core/evaluation/class_names.py).

The port's own copy of ``arfe_tpu/core/evaluation/class_names.py``.
"""


def coco_classes():
    return [
        'person', 'bicycle', 'car', 'motorcycle', 'airplane', 'bus', 'train',
        'truck', 'boat', 'traffic_light', 'fire_hydrant', 'stop_sign',
        'parking_meter', 'bench', 'bird', 'cat', 'dog', 'horse', 'sheep',
        'cow', 'elephant', 'bear', 'zebra', 'giraffe', 'backpack',
        'umbrella', 'handbag', 'tie', 'suitcase', 'frisbee', 'skis',
        'snowboard', 'sports_ball', 'kite', 'baseball_bat',
        'baseball_glove', 'skateboard', 'surfboard', 'tennis_racket',
        'bottle', 'wine_glass', 'cup', 'fork', 'knife', 'spoon', 'bowl',
        'banana', 'apple', 'sandwich', 'orange', 'broccoli', 'carrot',
        'hot_dog', 'pizza', 'donut', 'cake', 'chair', 'couch',
        'potted_plant', 'bed', 'dining_table', 'toilet', 'tv', 'laptop',
        'mouse', 'remote', 'keyboard', 'cell_phone', 'microwave', 'oven',
        'toaster', 'sink', 'refrigerator', 'book', 'clock', 'vase',
        'scissors', 'teddy_bear', 'hair_drier', 'toothbrush',
    ]


def voc_classes():
    return [
        'aeroplane', 'bicycle', 'bird', 'boat', 'bottle', 'bus', 'car',
        'cat', 'chair', 'cow', 'diningtable', 'dog', 'horse', 'motorbike',
        'person', 'pottedplant', 'sheep', 'sofa', 'train', 'tvmonitor',
    ]


def visdrone_classes():
    """(ref: mmdet/datasets/visdrone.py:5-11 — 12 classes)."""
    return [
        'ignored-regions', 'pedestrian', 'people', 'bicycle', 'car', 'van',
        'truck', 'tricycle', 'awning-tricycle', 'bus', 'motor', 'others',
    ]


def cityscapes_classes():
    return ['person', 'rider', 'car', 'truck', 'bus', 'train', 'motorcycle',
            'bicycle']


def wider_face_classes():
    return ['face']


def imagenet_det_classes():
    raise NotImplementedError('imagenet det class table not bundled')


dataset_aliases = {
    'voc': ['voc', 'pascal_voc', 'voc07', 'voc12'],
    'coco': ['coco', 'mscoco', 'ms_coco'],
    'wider_face': ['WIDERFaceDataset', 'wider_face', 'WDIERFace'],
    'cityscapes': ['cityscapes'],
    'visdrone': ['visdrone', 'VisdroneDataset'],
}


def get_classes(dataset):
    for name, aliases in dataset_aliases.items():
        if dataset in aliases:
            return globals()[f'{name}_classes']()
    raise ValueError(f'Unrecognized dataset: {dataset}')
