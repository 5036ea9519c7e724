"""The roofline of an LM step on the H100 (``analysis``) and its table over
the dry run's JSONs (``table``)."""
from repro_torch.roofline.analysis import (
    CellStats,
    CollectiveOp,
    RooflineReport,
    link_bandwidth,
    model_flops_for,
    price,
    roofline,
)
