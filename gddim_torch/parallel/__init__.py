"""Parallelism over ``torch.distributed`` (counterpart of
``gddim_tpu/parallel/``): the process group and its helpers
(``multihost.py``), the device meshes, the placement rules and the
placements of a training state (``mesh.py``), and the draws of a batch
sharded over ranks (``draws.py``). The names load on first use, so that
importing the package does not import ``torch.distributed``."""

_MESH = ("make_mesh", "make_mesh_2d", "make_mesh_3d", "fsdp_spec", "tp_spec", "fsdp_shard_params",
         "tp_shard_params", "replicate_to_mesh", "shard_batch", "Placement", "place_model")
_MULTIHOST = ("allgather_metrics", "barrier", "initialize_distributed", "is_coordinator",
              "process_count", "process_index", "local_device", "shutdown")

__all__ = [*_MESH, *_MULTIHOST]


def __getattr__(name):
    import importlib

    if name in _MESH:
        return getattr(importlib.import_module("gddim_torch.parallel.mesh"), name)
    if name in _MULTIHOST:
        return getattr(importlib.import_module("gddim_torch.parallel.multihost"), name)
    raise AttributeError(name)
