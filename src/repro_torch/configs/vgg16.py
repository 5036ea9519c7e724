"""VGG16 (the paper's image-classification network): 13 conv (all 3x3
stride-1) + 3 FC layers, as data."""
from repro_torch.api.model import CNNModel
from repro_torch.models.cnn import CNNLayer

C = CNNLayer


def _conv(ch):
    return C("conv", out_channels=ch, kernel=3, stride=1, batch_norm=True,
             activation="relu")


LAYERS = (
    _conv(64), _conv(64), C("maxpool", size=2, stride=2),
    _conv(128), _conv(128), C("maxpool", size=2, stride=2),
    _conv(256), _conv(256), _conv(256), C("maxpool", size=2, stride=2),
    _conv(512), _conv(512), _conv(512), C("maxpool", size=2, stride=2),
    _conv(512), _conv(512), _conv(512), C("maxpool", size=2, stride=2),
    C("fc", out_channels=4096, activation="relu", batch_norm=False),
    C("fc", out_channels=4096, activation="relu", batch_norm=False),
    C("fc", out_channels=1000, activation="linear", batch_norm=False),
)

INPUT_HW = (224, 224)
NAME = "vgg16"

MODEL = CNNModel(LAYERS, INPUT_HW, in_channels=3, name=NAME)
