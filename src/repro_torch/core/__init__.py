from repro_torch.core.conv2d import conv2d, conv2d_reference
from repro_torch.core.conv_spec import (
    ConvAlgorithm,
    ConvSpec,
    Epilogue,
    select_algorithm,
)
from repro_torch.core.netplan import (
    Layout,
    NetworkExecutor,
    NetworkPlan,
    build_network_plan,
    plan_network,
    prepare_net_params,
    run_network,
)
from repro_torch.core.planner import ConvPlan, Planner

__all__ = [
    "ConvAlgorithm",
    "ConvPlan",
    "ConvSpec",
    "Epilogue",
    "Layout",
    "NetworkExecutor",
    "NetworkPlan",
    "Planner",
    "build_network_plan",
    "conv2d",
    "conv2d_reference",
    "plan_network",
    "prepare_net_params",
    "run_network",
    "select_algorithm",
]
