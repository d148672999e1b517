"""Category vocabularies and palettes: a copy of ``peanut_tpu.constants``
(PEANUT's nav/constants.py), kept so the port never imports the JAX package."""

hm3d_names = {0: "chair", 1: "bed", 2: "plant", 3: "toilet", 4: "tv_monitor",
              5: "sofa"}

# HM3D goal id -> index in the 6-goal map-channel space used by prediction
hm3d_to_coco = {0: 0, 1: 3, 2: 2, 3: 4, 4: 5, 5: 1}
coco_to_hm3d = {v: k for k, v in hm3d_to_coco.items()}

# the 9 categories of the fine-tuned Mask R-CNN (map channels 4..12)
map_category_names = {0: "chair", 1: "sofa", 2: "plant", 3: "bed",
                      4: "toilet", 5: "tv_monitor", 6: "fireplace",
                      7: "bathtub", 8: "mirror"}

coco_categories = {
    "chair": 0, "couch": 1, "potted plant": 2, "bed": 3, "toilet": 4,
    "tv": 5, "dining-table": 6, "oven": 7, "sink": 8, "refrigerator": 9,
    "book": 10, "clock": 11, "vase": 12, "cup": 13, "bottle": 14,
}

color_palette = [
    1.0, 1.0, 1.0,
    0.6, 0.6, 0.6,
    0.9, 0.9, 0.9,
    0.96, 0.36, 0.26,
    0.12156862745098039, 0.47058823529411764, 0.7058823529411765,
    0.9400000000000001, 0.7818, 0.66,
    0.9400000000000001, 0.8868, 0.66,
    0.8882000000000001, 0.9400000000000001, 0.66,
    0.7832000000000001, 0.9400000000000001, 0.66,
    0.6782000000000001, 0.9400000000000001, 0.66,
    0.66, 0.9400000000000001, 0.7468000000000001,
    0.66, 0.9400000000000001, 0.8518000000000001,
    0.66, 0.9232, 0.9400000000000001,
    0.66, 0.8182, 0.9400000000000001,
    0.66, 0.7132, 0.9400000000000001,
    0.7117999999999999, 0.66, 0.9400000000000001,
    0.8168, 0.66, 0.9400000000000001,
    0.9218, 0.66, 0.9400000000000001,
    0.9400000000000001, 0.66, 0.8531999999999998,
    0.9400000000000001, 0.66, 0.748199999999999,
    0.300000000000001, 0.66, 0.8531999999999998,
    0.9400000000000001, 0.06, 0.8531999999999998,
    0.9400000000000001, 0.66, 0.5531999999999998,
    0.3400000000000001, 0.96, 0.2531999999999998,
]
