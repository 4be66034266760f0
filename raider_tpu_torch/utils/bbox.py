"""Bounding-box arithmetic (counterpart of ``raider_tpu/utils/bbox.py``)."""

from typing import List, Sequence, Union

import numpy as np


def clip_bbox(bbox: Sequence[float], spacing: Union[int, float]) -> List[float]:
    """Clip an SNWE box outward to multiples of ``spacing``."""
    return [
        float(np.floor(bbox[0] / spacing) * spacing),
        float(np.ceil(bbox[1] / spacing) * spacing),
        float(np.floor(bbox[2] / spacing) * spacing),
        float(np.ceil(bbox[3] / spacing) * spacing),
    ]
