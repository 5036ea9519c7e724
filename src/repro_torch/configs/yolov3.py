"""YOLOv3 layer tables (the paper's object-detection network), as data.

- LAYERS_20: the first 20 Darknet-53 layers (15 conv + shortcuts), the
  slice the paper uses for its hardware sweeps (§VI.B).
- TINY_LAYERS: full YOLOv3-tiny (13 conv), the paper's detection network.
"""
from repro_torch.api.model import CNNModel
from repro_torch.models.cnn import CNNLayer

C = CNNLayer


def _c(ch, k=3, s=1):
    return C("conv", out_channels=ch, kernel=k, stride=s, batch_norm=True,
             activation="leaky")


# First 20 layers of Darknet-53 (conv + residual shortcuts).
LAYERS_20 = (
    _c(32, 3, 1),            # 0
    _c(64, 3, 2),            # 1
    _c(32, 1, 1),            # 2
    _c(64, 3, 1),            # 3
    C("shortcut", from_layers=(1,)),   # 4
    _c(128, 3, 2),           # 5
    _c(64, 1, 1),            # 6
    _c(128, 3, 1),           # 7
    C("shortcut", from_layers=(5,)),   # 8
    _c(64, 1, 1),            # 9
    _c(128, 3, 1),           # 10
    C("shortcut", from_layers=(8,)),   # 11
    _c(256, 3, 2),           # 12
    _c(128, 1, 1),           # 13
    _c(256, 3, 1),           # 14
    C("shortcut", from_layers=(12,)),  # 15
    _c(128, 1, 1),           # 16
    _c(256, 3, 1),           # 17
    C("shortcut", from_layers=(15,)),  # 18
    _c(128, 1, 1),           # 19
)

# Full YOLOv3-tiny.
TINY_LAYERS = (
    _c(16), C("maxpool", size=2, stride=2),
    _c(32), C("maxpool", size=2, stride=2),
    _c(64), C("maxpool", size=2, stride=2),
    _c(128), C("maxpool", size=2, stride=2),
    _c(256), C("maxpool", size=2, stride=2),          # idx 8 = route source
    _c(512), C("maxpool", size=2, stride=1),
    _c(1024),                                          # 12
    _c(256, 1, 1),                                     # 13 = route source
    _c(512),                                           # 14
    C("conv", out_channels=255, kernel=1, batch_norm=False,
      activation="linear"),                            # 15 detection head 1
    C("route", from_layers=(13,)),                     # 16
    _c(128, 1, 1),                                     # 17
    C("upsample", size=2),                             # 18
    C("route", from_layers=(18, 8)),                   # 19
    _c(256),                                           # 20
    C("conv", out_channels=255, kernel=1, batch_norm=False,
      activation="linear"),                            # 21 detection head 2
)

INPUT_HW = (608, 608)
TINY_INPUT_HW = (416, 416)
NAME = "yolov3"

MODEL_20 = CNNModel(LAYERS_20, INPUT_HW, in_channels=3, name="yolov3-20")
TINY_MODEL = CNNModel(TINY_LAYERS, TINY_INPUT_HW, in_channels=3,
                      name="yolov3-tiny")
