"""Dataset label vocabularies (the port's copy of
``peanut_tpu.prediction.class_names``; mmseg core/evaluation/
class_names.py parity).

The vocabularies the zoo's configs and datasets name; ``get_classes``
takes the same aliases as the reference.
"""

from __future__ import annotations

CITYSCAPES = [
    "road", "sidewalk", "building", "wall", "fence", "pole",
    "traffic light", "traffic sign", "vegetation", "terrain", "sky",
    "person", "rider", "car", "truck", "bus", "train", "motorcycle",
    "bicycle"]

ADE20K = [
    "wall", "building", "sky", "floor", "tree", "ceiling", "road", "bed",
    "windowpane", "grass", "cabinet", "sidewalk", "person", "earth", "door",
    "table", "mountain", "plant", "curtain", "chair", "car", "water",
    "painting", "sofa", "shelf", "house", "sea", "mirror", "rug", "field",
    "armchair", "seat", "fence", "desk", "rock", "wardrobe", "lamp",
    "bathtub", "railing", "cushion", "base", "box", "column", "signboard",
    "chest of drawers", "counter", "sand", "sink", "skyscraper",
    "fireplace", "refrigerator", "grandstand", "path", "stairs", "runway",
    "case", "pool table", "pillow", "screen door", "stairway", "river",
    "bridge", "bookcase", "blind", "coffee table", "toilet", "flower",
    "book", "hill", "bench", "countertop", "stove", "palm",
    "kitchen island", "computer", "swivel chair", "boat", "bar",
    "arcade machine", "hovel", "bus", "towel", "light", "truck", "tower",
    "chandelier", "awning", "streetlight", "booth", "television receiver",
    "airplane", "dirt track", "apparel", "pole", "land", "bannister",
    "escalator", "ottoman", "bottle", "buffet", "poster", "stage", "van",
    "ship", "fountain", "conveyer belt", "canopy", "washer", "plaything",
    "swimming pool", "stool", "barrel", "basket", "waterfall", "tent",
    "bag", "minibike", "cradle", "oven", "ball", "food", "step", "tank",
    "trade name", "microwave", "pot", "animal", "bicycle", "lake",
    "dishwasher", "screen", "blanket", "sculpture", "hood", "sconce",
    "vase", "traffic light", "tray", "ashcan", "fan", "pier", "crt screen",
    "plate", "monitor", "bulletin board", "shower", "radiator", "glass",
    "clock", "flag"]

VOC = [
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse",
    "motorbike", "person", "pottedplant", "sheep", "sofa", "train",
    "tvmonitor"]

# retina-vessel segmentation datasets (chase_db1/drive/hrf/stare)
VESSEL = ["background", "vessel"]

COCOSTUFF = [
    "person", "bicycle", "car", "motorcycle", "airplane", "bus", "train",
    "truck", "boat", "traffic light", "fire hydrant", "stop sign",
    "parking meter", "bench", "bird", "cat", "dog", "horse", "sheep",
    "cow", "elephant", "bear", "zebra", "giraffe", "backpack", "umbrella",
    "handbag", "tie", "suitcase", "frisbee", "skis", "snowboard",
    "sports ball", "kite", "baseball bat", "baseball glove", "skateboard",
    "surfboard", "tennis racket", "bottle", "wine glass", "cup", "fork",
    "knife", "spoon", "bowl", "banana", "apple", "sandwich", "orange",
    "broccoli", "carrot", "hot dog", "pizza", "donut", "cake", "chair",
    "couch", "potted plant", "bed", "dining table", "toilet", "tv",
    "laptop", "mouse", "remote", "keyboard", "cell phone", "microwave",
    "oven", "toaster", "sink", "refrigerator", "book", "clock", "vase",
    "scissors", "teddy bear", "hair drier", "toothbrush", "banner",
    "blanket", "branch", "bridge", "building-other", "bush", "cabinet",
    "cage", "cardboard", "carpet", "ceiling-other", "ceiling-tile",
    "cloth", "clothes", "clouds", "counter", "cupboard", "curtain",
    "desk-stuff", "dirt", "door-stuff", "fence", "floor-marble",
    "floor-other", "floor-stone", "floor-tile", "floor-wood", "flower",
    "fog", "food-other", "fruit", "furniture-other", "grass", "gravel",
    "ground-other", "hill", "house", "leaves", "light", "mat", "metal",
    "mirror-stuff", "moss", "mountain", "mud", "napkin", "net", "paper",
    "pavement", "pillow", "plant-other", "plastic", "platform",
    "playingfield", "railing", "railroad", "river", "road", "rock", "roof",
    "rug", "salad", "sand", "sea", "shelf", "sky-other", "skyscraper",
    "snow", "solid-other", "stairs", "stone", "straw", "structural-other",
    "table", "tent", "textile-other", "towel", "tree", "vegetable",
    "wall-brick", "wall-concrete", "wall-other", "wall-panel",
    "wall-stone", "wall-tile", "wall-wood", "water-other", "waterdrops",
    "window-blind", "window-other", "wood"]

LOVEDA = ["background", "building", "road", "water", "barren", "forest",
          "agricultural"]

# ISPRS Potsdam / Vaihingen share one vocabulary
ISPRS = ["impervious_surface", "building", "low_vegetation", "tree", "car",
         "clutter"]

ISAID = [
    "background", "ship", "store_tank", "baseball_diamond", "tennis_court",
    "basketball_court", "Ground_Track_Field", "Bridge", "Large_Vehicle",
    "Small_Vehicle", "Helicopter", "Swimming_pool", "Roundabout",
    "Soccer_ball_field", "plane", "Harbor"]

PASCAL_CONTEXT = [
    "background", "aeroplane", "bag", "bed", "bedclothes", "bench",
    "bicycle", "bird", "boat", "book", "bottle", "building", "bus",
    "cabinet", "car", "cat", "ceiling", "chair", "cloth", "computer",
    "cow", "cup", "curtain", "dog", "door", "fence", "floor", "flower",
    "food", "grass", "ground", "horse", "keyboard", "light", "motorbike",
    "mountain", "mouse", "person", "plate", "platform", "pottedplant",
    "road", "rock", "sheep", "shelves", "sidewalk", "sign", "sky", "snow",
    "sofa", "table", "track", "train", "tree", "truck", "tvmonitor",
    "wall", "water", "window", "wood"]

# the 59-class variant drops "background" (reduce_zero_label pipeline)
PASCAL_CONTEXT_59 = PASCAL_CONTEXT[1:]

# PEANUT's own vocabularies (constants.py)
from ..constants import hm3d_names, map_category_names  # noqa: E402

HM3D_GOALS = [hm3d_names[i] for i in range(6)]
PEANUT_MAP_CATEGORIES = [map_category_names[i] for i in range(9)]

_ALIASES = {
    "cityscapes": CITYSCAPES,
    "ade": ADE20K,
    "ade20k": ADE20K,
    "voc": VOC,
    "pascal_voc": VOC,
    "hm3d": HM3D_GOALS,
    "peanut": PEANUT_MAP_CATEGORIES,
    "vessel": VESSEL,
    "stare": VESSEL,
    "drive": VESSEL,
    "chase_db1": VESSEL,
    "hrf": VESSEL,
    "cocostuff": COCOSTUFF,
    "coco_stuff": COCOSTUFF,
    "coco-stuff": COCOSTUFF,
    "loveda": LOVEDA,
    "potsdam": ISPRS,
    "vaihingen": ISPRS,
    "isprs": ISPRS,
    "isaid": ISAID,
    "pascal_context": PASCAL_CONTEXT,
    "pascal_context59": PASCAL_CONTEXT_59,
}


def get_classes(dataset: str):
    key = dataset.lower()
    if key not in _ALIASES:
        raise KeyError(f"Unknown dataset {dataset!r}; "
                       f"available: {sorted(_ALIASES)}")
    return list(_ALIASES[key])
