"""A world of one for the port's in-process mesh tests: a gloo process
group of one rank (rendezvous through a ``FileStore`` in a fresh
temporary directory, never a port) and its (1, 1) ``DeviceMesh`` on the
CPU.  The multi-rank cases spawn their own worlds
(``tests/test_torch_dist.py``)."""

import functools
import os
import tempfile


@functools.lru_cache(maxsize=None)
def mesh_of_one():
    import torch.distributed as dist

    from repro_torch.dist.spmd import init_mesh

    if not dist.is_initialized():
        store = os.path.join(tempfile.mkdtemp(prefix="mesh1_"), "store")
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=1, rank=0)
    return init_mesh((1, 1), device_type="cpu")


def rules_of_one(**kw):
    from repro_torch.dist.sharding import ShardingRules

    return ShardingRules.for_mesh(mesh_of_one(), **kw)
