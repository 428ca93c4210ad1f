"""Box format helpers (counterpart of ``arfe_tpu/core/bbox/transforms.py``)."""
from __future__ import annotations

import numpy as np


def bbox2result(bboxes, labels, num_classes):
    """Detections to the reference's result format: a list of
    ``num_classes`` float32 arrays of shape (k, 5). Rows with score <= -1
    (padding) are dropped. Host-side: takes arrays or CPU tensors."""
    bboxes = np.asarray(bboxes)
    labels = np.asarray(labels)
    valid = bboxes[:, 4] > -1
    bboxes, labels = bboxes[valid], labels[valid]
    return [bboxes[labels == i, :].astype(np.float32)
            for i in range(num_classes)]
