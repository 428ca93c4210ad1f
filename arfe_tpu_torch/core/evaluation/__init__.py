from .class_names import (coco_classes, dataset_aliases, get_classes,
                          visdrone_classes, voc_classes)
from .coco_eval import COCOEvaluator

__all__ = ['COCOEvaluator', 'coco_classes', 'dataset_aliases',
           'get_classes', 'visdrone_classes', 'voc_classes']
