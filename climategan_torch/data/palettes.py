"""Class palettes and the KITTI -> ClimateGAN label merge (numpy), the
port's own copy of the JAX package's ``data/palettes.py`` (a re-design of
reference climategan/data.py:21-148)."""
from __future__ import annotations

import numpy as np

CLASSES = {
    "s": {  # unity simulator palette (RGBA)
        0: (0, 0, 255, 255),        # Water
        1: (55, 55, 55, 255),       # Ground
        2: (0, 255, 255, 255),      # Building
        3: (255, 212, 0, 255),      # Traffic items
        4: (0, 255, 0, 255),        # Vegetation
        5: (255, 97, 0, 255),       # Terrain
        6: (255, 0, 0, 255),        # Car
        7: (60, 180, 60, 255),      # Trees
        8: (255, 0, 255, 255),      # Person
        9: (0, 0, 0, 255),          # Sky
        10: (255, 255, 255, 255),   # Default
    },
    "r": {  # deeplab-v2 palette
        0: (0, 0, 255, 255),
        1: (55, 55, 55, 255),
        2: (0, 255, 255, 255),
        3: (255, 212, 0, 255),
        4: (0, 255, 0, 255),
        5: (255, 97, 0, 255),
        6: (255, 0, 0, 255),
        7: (60, 180, 60, 255),
        8: (220, 20, 60, 255),
        9: (8, 19, 49, 255),
        10: (0, 80, 100, 255),
    },
    "kitti": {
        0: (210, 0, 200),    # Terrain
        1: (90, 200, 255),   # Sky
        2: (0, 199, 0),      # Tree
        3: (90, 240, 0),     # Vegetation
        4: (140, 140, 140),  # Building
        5: (100, 60, 100),   # Road
        6: (250, 100, 255),  # GuardRail
        7: (255, 255, 0),    # TrafficSign
        8: (200, 200, 0),    # TrafficLight
        9: (255, 130, 0),    # Pole
        10: (80, 80, 80),    # Misc
        11: (160, 60, 60),   # Truck
        12: (255, 127, 80),  # Car
        13: (0, 139, 139),   # Van
        14: (0, 0, 0),       # Undefined
    },
    "flood": {
        0: (255, 0, 0),  # Cannot flood
        1: (0, 0, 255),  # Must flood
        2: (0, 0, 0),    # May flood
    },
}

# kitti class -> climategan class (reference data.py:72-88)
KITTI_TO_CLIMATEGAN = {
    0: 5, 1: 9, 2: 7, 3: 4, 4: 2, 5: 1, 6: 3, 7: 3, 8: 3, 9: 3,
    10: 10, 11: 6, 12: 6, 13: 6, 14: 10,
}


def encode_exact_segmap(seg: np.ndarray, classes: dict,
                        default_value: int = 14) -> np.ndarray:
    """Exact RGB -> label map (reference data.py:91-108)."""
    n = len(next(iter(classes.values())))
    seg = seg[..., :n]
    out = np.full(seg.shape[:2], default_value, dtype=np.int64)
    for label, rgb in classes.items():
        out[(seg == np.asarray(rgb[:n])).all(-1)] = label
    return out


def merge_labels(labels: np.ndarray, mapping: dict,
                 default_value: int = 14) -> np.ndarray:
    """Source-domain labels -> target labels (reference data.py:111-128)."""
    out = np.full_like(labels, default_value)
    for src, tgt in mapping.items():
        out[labels == src] = tgt
    return out


def process_kitti_seg(rgb_seg: np.ndarray, default: int = 14) -> np.ndarray:
    """kitti RGB segmap -> climategan labels (reference data.py:131-148)."""
    labels = encode_exact_segmap(rgb_seg, CLASSES["kitti"], default)
    return merge_labels(labels, KITTI_TO_CLIMATEGAN, default)
