"""Datasets, the train and test pipelines and the loader of the port;
importing this registers the datasets and the pipeline transforms."""
from . import synthetic
from .builder import (GroupBatchSampler, build_dataloader, build_dataset,
                      collate_test, collate_train)
from .coco import CocoDataset
from .coco_api import COCO
from .custom import CustomDataset
from .pipelines import Compose

__all__ = ['COCO', 'CocoDataset', 'Compose', 'CustomDataset',
           'GroupBatchSampler', 'build_dataloader', 'build_dataset',
           'collate_test', 'collate_train', 'synthetic']
