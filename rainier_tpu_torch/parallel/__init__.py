from .checkpoint import load_checkpoint, resume_config, save_checkpoint
from .data import shard_columns, sharded_logp_fn
from .distributed import initialize, is_primary
from .mesh import (CHAINS, DATA, chain_sharding, data_sharding, make_mesh,
                   replicated)

__all__ = [
    "load_checkpoint", "resume_config", "save_checkpoint", "shard_columns",
    "sharded_logp_fn", "initialize", "is_primary", "CHAINS", "DATA",
    "chain_sharding", "data_sharding", "make_mesh", "replicated",
]
