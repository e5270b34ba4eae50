"""Data-parallel SNN execution on a device mesh (port of
``repro.parallel``).

    from repro_torch.parallel import DataMesh, data_mesh, infer_batch_sharded, use_mesh

    mesh = data_mesh()                       # every visible card
    mesh = DataMesh(("cpu",) * 4)            # or a virtual mesh on one device
    logits, stats = infer_batch_sharded(params, th, cfg, images,
                                        backend="queue_pallas", mesh=mesh)
    with use_mesh(mesh):                     # or: route infer_batch itself
        report = study.run(spec)

Sharded execution is **bit-exact** against the single-device
``engine.infer_batch`` (logits and stats), so a mesh is a throughput knob
only: caches, studies and served responses are interchangeable with the
single-device path.
"""
from .executor import (batch_runner_sharded, infer_batch_sharded,  # noqa: F401
                       use_mesh)
from .mesh import (DATA_AXIS, DataMesh, data_mesh, device_count,  # noqa: F401
                   mesh_size)

__all__ = [
    "DATA_AXIS", "DataMesh", "data_mesh", "device_count", "mesh_size",
    "batch_runner_sharded", "infer_batch_sharded", "use_mesh",
]
