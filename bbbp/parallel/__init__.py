from bbbp.parallel.mesh import make_mesh, batch_sharding, replicated
from bbbp.parallel.prefetch import prefetch_to_device

__all__ = ["make_mesh", "batch_sharding", "replicated", "prefetch_to_device"]
