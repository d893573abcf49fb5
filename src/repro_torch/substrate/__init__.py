"""repro_torch.substrate — the process-placement seam the engine pool probes
through.  Meshes, sharding and collectives arrive with the port of the
distribution substrate."""
from .compat import host_id, process_topology

__all__ = ["host_id", "process_topology"]
