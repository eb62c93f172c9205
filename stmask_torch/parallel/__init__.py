"""Data-parallel training over processes (``torch.distributed``)."""

from .collectives import (all_gather_cat, all_reduce_sum, barrier,  # noqa
                          rank, world_size)
from .mesh import (GROUP_TIMEOUT, initialize_multihost,  # noqa: F401
                   replicate, shard_batch)
