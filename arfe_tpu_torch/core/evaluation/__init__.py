from .class_names import (coco_classes, dataset_aliases, get_classes,
                          visdrone_classes, voc_classes)
from .coco_eval import COCOEvaluator
from .recall import bbox_overlaps_np, eval_recalls

__all__ = ['COCOEvaluator', 'bbox_overlaps_np', 'coco_classes',
           'dataset_aliases', 'eval_recalls', 'get_classes',
           'visdrone_classes', 'voc_classes']
