from repro_torch.roofline.analysis import (
    H100,
    HardwareSpec,
    RooflineReport,
    analyze_plan,
    model_flops,
    placed_bytes,
    placed_memory,
)

__all__ = [
    "H100",
    "HardwareSpec",
    "RooflineReport",
    "analyze_plan",
    "model_flops",
    "placed_bytes",
    "placed_memory",
]
