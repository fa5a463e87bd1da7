"""OptiReduce core over the peer axis: TAR, the drop model, the randomized
Hadamard codec, bucketing and the sync engine (see ``core/allreduce.py``)."""
from .allreduce import (OptiReduceConfig, SyncContext, strategy_names,
                        sync_bucket, sync_packed, sync_pytree)
from .bucket_plan import BucketPlan
from .pipeline import CollectiveSpec, GeneratorDraws, resolve_spec

__all__ = ["BucketPlan", "CollectiveSpec", "GeneratorDraws",
           "OptiReduceConfig", "SyncContext", "resolve_spec", "strategy_names",
           "sync_bucket", "sync_packed", "sync_pytree"]
