"""Datasets, the test pipeline and the test loader of the port; importing
this registers the datasets and the pipeline transforms."""
from . import synthetic
from .builder import build_dataloader, build_dataset, collate_test
from .coco import CocoDataset
from .coco_api import COCO
from .custom import CustomDataset
from .pipelines import Compose

__all__ = ['COCO', 'CocoDataset', 'Compose', 'CustomDataset',
           'build_dataloader', 'build_dataset', 'collate_test', 'synthetic']
