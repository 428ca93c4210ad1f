"""Datasets, the train and test pipelines and the loader of the port;
importing this registers the datasets and the pipeline transforms."""
from . import synthetic
from .builder import (GroupBatchSampler, build_dataloader, build_dataset,
                      collate_test, collate_train)
from .coco import CocoDataset, VisdroneDataset
from .coco_api import COCO
from .custom import CustomDataset
from .dataset_wrappers import (ClassBalancedDataset, ConcatDataset,
                               RepeatDataset)
from .pipelines import Compose

__all__ = ['COCO', 'ClassBalancedDataset', 'CocoDataset', 'Compose',
           'ConcatDataset', 'CustomDataset', 'GroupBatchSampler',
           'RepeatDataset', 'VisdroneDataset', 'build_dataloader',
           'build_dataset', 'collate_test', 'collate_train', 'synthetic']
