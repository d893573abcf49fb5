"""repro_torch.graphs — workload substrate: the paper's random graph generator and
real-world application DAGs."""
from .irregular import heavy_tail_fan_in, star_fan_in
from .realworld import epigenomics, fft_graph, gaussian_elimination, molecular_dynamics
from .rgg import Workload, classic_workload, interval_workload, rgg_structure, rgg

__all__ = [
    "Workload", "classic_workload", "epigenomics", "fft_graph",
    "gaussian_elimination", "heavy_tail_fan_in", "interval_workload",
    "molecular_dynamics", "rgg", "rgg_structure", "star_fan_in",
]
