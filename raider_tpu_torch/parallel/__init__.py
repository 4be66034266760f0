"""Several devices: ray sharding and z-slab tables.

Counterpart of ``raider_tpu/parallel``. Two decompositions over a 1-D mesh
of devices (``mesh.Mesh``):
  * ray sharding (``mesh.shard_rays``, ``mesh.place_ray_arrays``): the
    table replicated on each device, the rays split; no collective;
  * z-slab tables (``zshard.integrate_rays_z_sharded``): the table split
    into z-slabs, the rays replicated, the partial integrals summed; for
    tables past one device's memory.
"""

from raider_tpu_torch.parallel.mesh import (Mesh, default_mesh, device_get_global,  # noqa: F401
                                            get_mesh, initialize_distributed, shard_rays)
from raider_tpu_torch.parallel.zshard import (integrate_rays_z_sharded,  # noqa: F401
                                              pack_cube_slabs, zshard_auto)
